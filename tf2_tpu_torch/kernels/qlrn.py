"""Fused int8 LRN across channels: int8 NHWC in, int8 out, in one pass.

    xf  = f32(q) * s_in;  sq = xf * xf
    win = sum of sq over channels [c - r, c + r] within [0, C), in float64,
          rounded once to f32
    t   = bias + alpha * win
    rs  = 1 / sqrt(t);  y = (xf * rs) * sqrt(rs)        (beta = 0.75)
    out = clip(rint(y / s_out), +-127)

``qlrn`` launches ``csrc/qlrn.cu`` on CUDA tensors and takes the plain
version (``qlrn_plain``) on CPU tensors. Every step is one correctly
rounded operation (IEEE square root and division, no fused multiply-add),
and the window sum of squares of dequantized int8 values is exact in
float64 in any order, so the kernel, the plain version on the card and the
plain version on the CPU give the same bits. ``tf2_tpu.kernels.qlrn`` sums
the window in f32 as a band matmul and takes ``rsqrt``: the two agree to
within one quantum at rounding boundaries.

Every scalar is the node's double rounded once to f32 (``_f32``), on both
sides. For beta != 0.75 the plain version takes ``torch.pow``, as the
reference does; the kernel does not take it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import build

LAUNCHES = {"qlrn": 0}
_SIG = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("qlrn.cu")
    lib.tf2_qlrn.argtypes, lib.tf2_qlrn.restype = _SIG, ctypes.c_int
    lib.tf2_qlrn_max_channels.argtypes, lib.tf2_qlrn_max_channels.restype = [], ctypes.c_int
    return lib


def _f32(v: float) -> float:
    return float(np.float32(v))


def _beta_is_075(beta: float) -> bool:
    return abs(beta - 0.75) < 1e-12


def lrn_f32(xf: torch.Tensor, *, radius: int, alpha: float, beta: float,
            bias: float) -> torch.Tensor:
    """LRN across the last axis of an f32 tensor, step by step as above."""
    c = xf.shape[-1]
    sq = F.pad((xf * xf).to(torch.float64), (radius, radius))
    win = sq[..., 0:c]
    for j in range(1, 2 * radius + 1):
        win = win + sq[..., j:j + c]
    t = win.to(torch.float32) * _f32(alpha) + _f32(bias)
    if _beta_is_075(beta):
        rs = build.scalar(1.0, xf.device) / torch.sqrt(t)
        return (xf * rs) * torch.sqrt(rs)
    return xf / torch.pow(t, _f32(beta))


def qlrn_plain(x_q: torch.Tensor, *, radius: int, alpha: float, beta: float,
               bias: float, s_in: float, s_out: float) -> torch.Tensor:
    """Plain version of the kernel, on any device (``meta`` too)."""
    xf = x_q.to(torch.float32) * _f32(s_in)
    y = lrn_f32(xf, radius=radius, alpha=alpha, beta=beta, bias=bias)
    y = torch.round(y / build.scalar(_f32(s_out), x_q.device))
    return torch.clamp(y, -127, 127).to(torch.int8)


def qlrn(x_q: torch.Tensor, *, radius: int, alpha: float, beta: float, bias: float,
         s_in: float, s_out: float) -> torch.Tensor:
    """x_q (..., C) int8 -> int8 of the same shape. Raises on a CUDA tensor
    the kernel does not take (beta != 0.75, more channels than one block's
    shared memory holds)."""
    kw = dict(radius=radius, alpha=alpha, beta=beta, bias=bias, s_in=s_in, s_out=s_out)
    if x_q.device.type == "cpu":
        return qlrn_plain(x_q, **kw)
    if not _beta_is_075(beta):
        raise NotImplementedError(f"qlrn kernel: beta {beta} (it computes beta = 0.75)")
    c = x_q.shape[-1]
    m = x_q.numel() // c
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, tuple(x_q.shape)))
    if c > _lib().tf2_qlrn_max_channels():
        raise ValueError(f"qlrn kernel: {c} channels, at most "
                         f"{_lib().tf2_qlrn_max_channels()}")
    y = torch.empty_like(x_q)
    rc = _lib().tf2_qlrn(x_q.data_ptr(), y.data_ptr(), m, c, radius, _f32(s_in),
                         _f32(s_out), _f32(alpha), _f32(bias),
                         torch.cuda.current_stream(x_q.device).cuda_stream)
    build.check_launch(rc, "qlrn")
    LAUNCHES["qlrn"] += 1
    return y


def fused_qlrn(x_q: torch.Tensor, *, plain: bool = False, **kw) -> torch.Tensor:
    """Dispatch entry: the kernel, or its plain version when ``plain``."""
    return qlrn_plain(x_q, **kw) if plain else qlrn(x_q, **kw)
