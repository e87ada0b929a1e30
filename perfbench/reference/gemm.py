"""The conv and dense layers: int8 or 4-bit power-of-two weights, the sum
exact in float64, then the f32 epilogue

    y = clip(round(max?(f32(acc) * es + eb [+ f32(r) * radd_scale], 0)), +-127)

with each multiply and add rounded on its own."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .basic import requant
from .geometry import resolve_pads


def unpack_pot4(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(ceil(K/2), N) split-half packed 4-bit codes -> (K, N) int8 values.
    A code is sign (bit 3) and magnitude field m (bits 2:0): 0 for m = 0,
    else 2^(m-1)."""
    c = torch.cat([packed & 0xF, (packed >> 4) & 0xF], dim=0)[:k].to(torch.int32)
    m = c & 7
    mag = torch.where(m == 0, 0, torch.bitwise_left_shift(torch.ones_like(m),
                                                          torch.clamp_min(m - 1, 0)))
    return torch.where(((c >> 3) & 1) == 1, -mag, mag).to(torch.int8)


def weight(params, node) -> torch.Tensor:
    """The node's weight as int8 (K, N) or HWIO, decoded from its codes."""
    at = node["attrs"]
    w = params[node["params"][0]]
    kshape = at["kshape"]
    if at["wfmt"] == "pot4":
        return unpack_pot4(w, int(np.prod(kshape[:-1]))).reshape(kshape)
    if at["wfmt"] != "int8":
        raise NotImplementedError(f"reference: weight format {at['wfmt']!r}")
    return w.reshape(kshape)


def epilogue(acc, es, eb, relu: bool, residual=None) -> torch.Tensor:
    y = acc.to(torch.float32) * es + eb
    if residual is not None:
        r_q, scale = residual
        y = y + r_q.to(torch.float32) * float(np.float32(scale))
    if relu:
        y = torch.clamp_min(y, 0.0)
    return requant(y)


def qconv2d(node, params, x, ctx):
    at = node["attrs"]
    kh, kw, _, _ = at["kshape"]
    sh, sw = at.get("strides", [1, 1])
    padding = at.get("padding", "SAME")
    (ph0, ph1), (pw0, pw1) = resolve_pads(padding, kh, kw, sh, sw, x.shape[1], x.shape[2])
    w = weight(params, node)
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (pw0, pw1, ph0, ph1))
    acc = F.conv2d(xp, w.permute(3, 2, 0, 1).to(torch.float64), stride=(sh, sw),
                   groups=at.get("groups", 1))
    acc = acc.permute(0, 2, 3, 1).contiguous().round().to(torch.int32)
    es, eb = (params[p] for p in node["params"][1:3])
    return epilogue(acc, es, eb, at["relu"])


def qdense(node, params, x, *residual, ctx):
    at = node["attrs"]
    w = weight(params, node)
    x2 = x.reshape(-1, x.shape[-1])
    acc = torch.matmul(x2.to(torch.float64), w.to(torch.float64)).round().to(torch.int32)
    res = None
    if residual:
        (r,) = residual
        res = (r.reshape(-1, r.shape[-1]), at["radd_scale"])
    es, eb = (params[p] for p in node["params"][1:3])
    y = epilogue(acc, es, eb, at["relu"], res)
    return y.reshape(*x.shape[:-1], y.shape[-1])


OPS = {"qconv2d": qconv2d, "qdense": qdense}
