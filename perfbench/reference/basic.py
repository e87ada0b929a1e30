"""Quantize, dequantize, layout and the int8 elementwise ops."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import out_size, resolve_pads


def requant(y: torch.Tensor) -> torch.Tensor:
    """f32 -> int8: round half to even, clip to +-127."""
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def scalar(value: float, device, dtype=torch.float32) -> torch.Tensor:
    """``value`` as a 0-dim tensor, so that a division by it is a true
    division on the GPU too (a host scalar divides as a multiplication by
    its reciprocal there)."""
    return torch.tensor(value, dtype=dtype, device=device)


def quantize(node, params, x, ctx):
    y = torch.round(x.to(torch.float32) / scalar(float(node["attrs"]["scale"]), x.device))
    return torch.clamp(y, -127, 127).to(torch.int8)


def dequantize(node, params, x, ctx):
    return x.to(torch.float32) * node["attrs"]["scale"]


def reshape(node, params, x, ctx):
    shape = list(node["attrs"]["shape"])
    if node["attrs"].get("batch_leading"):
        shape[0] = ctx.batch
    return x.reshape(shape)


def transpose(node, params, x, ctx):
    return x.permute(node["attrs"]["perm"]).contiguous()


def qadd(node, params, a, b, ctx):
    at = node["attrs"]
    y = a.to(torch.float32) * (at["sa"] / at["so"]) + b.to(torch.float32) * (at["sb"] / at["so"])
    if at.get("relu"):
        y = torch.clamp_min(y, 0.0)
    return requant(y)


def maxpool(node, params, x, ctx):
    """Window max with TF padding, padded with the dtype's lowest value."""
    at = node["attrs"]
    wh, ww = at["window"]
    sh, sw = at["strides"]
    _, h, w, _ = x.shape
    (ph0, ph1), (pw0, pw1) = resolve_pads(at.get("padding", "VALID"), wh, ww, sh, sw, h, w)
    lowest = torch.finfo(x.dtype).min if x.is_floating_point() else torch.iinfo(x.dtype).min
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1), value=lowest)
    oh, ow = out_size(h, wh, sh, ph0, ph1), out_size(w, ww, sw, pw0, pw1)
    out = None
    for dy in range(wh):
        for dx in range(ww):
            v = xp[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw, :]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def global_avgpool(node, params, x, ctx):
    """Mean over H and W: the sum in float64 (exact for dequantized int8),
    a true division, rounded once to f32."""
    n = scalar(x.shape[1] * x.shape[2], x.device, torch.float64)
    return (x.to(torch.float64).sum(dim=(1, 2)) / n).to(torch.float32)


OPS = {"quantize": quantize, "dequantize": dequantize, "reshape": reshape,
       "transpose": transpose, "qadd": qadd, "maxpool": maxpool,
       "global_avgpool": global_avgpool}
