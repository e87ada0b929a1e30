"""The int8 transformer ops: layer norm, GELU, the position-embedding add
and the attention core, each in steps that give the same bits on the CPU
and the GPU."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .basic import requant, scalar


def f32(value: float) -> float:
    return float(np.float32(value))


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of an f32 tensor: the root in
    float64 rounded to f32, then moved one step where the exact midpoints
    with its neighbours say it lies on the other side."""
    x = t.to(torch.float64)
    r = torch.sqrt(x).to(torch.float32)
    lo = torch.nextafter(r, torch.zeros_like(r))
    hi = torch.nextafter(r, torch.full_like(r, float("inf")))
    r64 = r.to(torch.float64)
    m_lo = (lo.to(torch.float64) + r64) * 0.5
    m_hi = (r64 + hi.to(torch.float64)) * 0.5
    return torch.where(x < m_lo * m_lo, lo, torch.where(x > m_hi * m_hi, hi, r))


def qlayernorm(node, params, x, ctx):
    """Layer norm of the int8 codes with the exact integer mean and
    variance: y = ((x - mu) * (1 / sqrt(var + eps / s_in^2))) * (gamma /
    s_out) + beta / s_out, requantized."""
    at = node["attrs"]
    gamma, beta = (params[p].to(torch.float32) for p in node["params"])
    s_in, s_out = at["s_in"], at["s_out"]
    d = x.shape[-1]
    dev = x.device
    xi = x.to(torch.int64)
    s1 = xi.sum(dim=-1, keepdim=True)
    s2 = (xi * xi).sum(dim=-1, keepdim=True)
    mu = (s1.to(torch.float64) / scalar(d, dev, torch.float64)).to(torch.float32)
    var = ((d * s2 - s1 * s1).to(torch.float64)
           / scalar(d * d, dev, torch.float64)).to(torch.float32)
    eps = f32(at.get("eps", 1e-6) / (s_in * s_in))
    inv = scalar(1.0, dev) / sqrt_rn(var + eps)
    so = scalar(f32(s_out), dev)
    y = ((x.to(torch.float32) - mu) * inv) * (gamma / so) + beta / so
    return requant(y)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3)))), c = f32(sqrt(2/pi))."""
    c = f32(np.sqrt(2 / np.pi))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


@functools.lru_cache(maxsize=64)
def _gelu_table(s_in: float, s_out: float) -> torch.Tensor:
    """Every int8 input's output, computed once on the CPU in f32."""
    q = torch.arange(-128, 128, dtype=torch.float32)
    return requant(gelu_tanh(q * f32(s_in)) / torch.tensor(f32(s_out)))


def qgelu(node, params, x, ctx):
    table = _gelu_table(float(node["attrs"]["s_in"]), float(node["attrs"]["s_out"]))
    return table.to(x.device)[x.to(torch.int64) + 128]


def qbias_add(node, params, x, ctx):
    ratio = node["attrs"]["s_in"] / node["attrs"]["s_out"]
    return requant(x.to(torch.float32) * ratio + params[node["params"][0]].to(torch.float32))


def qattention_core(node, params, qkv, ctx):
    """Per head: the int8 QK^T exact, logits = f32(acc) * qk_scale, the
    softmax's exp and row sum in float64 each rounded once to f32, the
    probabilities on the grid 1/127, PV exact, requantized by pv_scale."""
    at = node["attrs"]
    heads, dim, s_in, s_out = at["heads"], at["dim"], at["s_in"], at["s_out"]
    n, t, _ = qkv.shape
    hd = dim // heads
    qk_scale = float(np.float32(np.float32(s_in * s_in) / np.sqrt(np.float32(hd))))
    pv_scale = f32(s_in / (127.0 * s_out))
    q, k, v = (z.reshape(n, t, heads, hd).transpose(1, 2).to(torch.float64)
               for z in torch.split(qkv, dim, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) * qk_scale
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp((logits - m).to(torch.float64)).to(torch.float32)
    total = e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
    p_q = torch.round((e / total) * 127.0)
    acc = torch.matmul(p_q.to(torch.float64), v).to(torch.float32)
    y = torch.clamp(torch.round(acc * pv_scale), -127, 127).to(torch.int8)
    return y.transpose(1, 2).reshape(n, t, dim)


OPS = {"qlayernorm": qlayernorm, "qgelu": qgelu, "qbias_add": qbias_add,
       "qattention_core": qattention_core}
