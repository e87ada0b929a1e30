"""Fused int8 LRN across channels: int8 NHWC in, int8 out, in one pass.

    xf  = f32(q) * s_in;  sq = xf * xf
    win = sum of sq over channels [c - r, c + r] within [0, C), in float64,
          rounded once to f32
    t   = bias + alpha * win
    rs  = 1 / sqrt(t);  y = (xf * rs) * sqrt(rs)        (beta = 0.75)
    y   = xf / f32(exp(beta * log(f64(t))))            (any other beta)
    out = clip(rint(y / s_out), +-127)

``qlrn`` launches ``csrc/qlrn.cu`` on CUDA tensors and takes the plain
version (``qlrn_plain``) on CPU tensors. Every step is one correctly
rounded operation (IEEE square root and division, no fused multiply-add),
and the window sum of squares of dequantized int8 values is exact in
float64 in any order, so the kernel, the plain version on the card and the
plain version on the CPU give the same bits. The kernel slides each
window along the channels (one add, one subtract an element: exact, by the
same bound) and at beta = 0.75 takes a fast epilogue wherever it is
certified to round as the exact steps do (within ``CERT_REL``), the
exact steps elsewhere. ``tf2_tpu.kernels.qlrn`` sums
the window in f32 as a band matmul and takes ``rsqrt``: the two agree to
within one quantum at rounding boundaries.

Every scalar is the node's double rounded once to f32 (``build.f32``), on
both sides. For beta != 0.75 both take t^beta as the double exp and log of
f64(t), rounded once to f32, where the reference takes the f32
``jnp.power``; ``torch.pow`` is not used, as it turns some exponents (0.5,
1, 2, -1, ...) into other operations, which the kernel would have to
mirror. The double exp and log on the card are the same functions in the
kernel and in the plain version; the CPU's may differ in the last bit of
the double.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

LAUNCHES = {"qlrn": 0}
# x, y, m, c, radius, s_in, s_out, alpha, bias, beta_075, beta, cert,
# slow_count, stream
_SIG = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
        + [ctypes.c_int, ctypes.c_double, ctypes.c_float] + [ctypes.c_void_p] * 2)
# The fast epilogue's z is within 2^-20 of xf * t^-0.75 / s_out and the
# exact steps within 7 * 2^-24 (csrc/qlrn.cu), so the two differ by less
# than 2^-19 |z|; the kernel takes the fast value where it lies farther
# than CERT_REL * |z| from every half-integer.
CERT_REL = 2.0 ** -17


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("qlrn.cu")
    lib.tf2_qlrn.argtypes, lib.tf2_qlrn.restype = _SIG, ctypes.c_int
    lib.tf2_qlrn_max_channels.argtypes, lib.tf2_qlrn_max_channels.restype = [], ctypes.c_int
    return lib


@functools.cache
def max_channels() -> int:
    """The most channels the kernel takes (one pixel's channels in one
    block's shared memory), from the library built for the card."""
    return _lib().tf2_qlrn_max_channels()


def covers(c: int, max_c: int) -> bool:
    """Does the kernel take rows of ``c`` channels, given the card's
    ``max_channels()``?"""
    return c <= max_c


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
    t = win.to(torch.float32) * build.f32(alpha) + build.f32(bias)
    if _beta_is_075(beta):
        rs = build.scalar(1.0, xf.device) / build.sqrt_rn(t)
        return (xf * rs) * build.sqrt_rn(rs)
    return xf / torch.exp(build.f32(beta) * torch.log(t.to(torch.float64))).to(torch.float32)


def qlrn_plain(x_q: torch.Tensor, *, radius: int, alpha: float, beta: float,
               bias: float, s_in: float, s_out: float) -> torch.Tensor:
    """Plain version of the kernel, on any device (``meta`` too)."""
    xf = x_q.to(torch.float32) * build.f32(s_in)
    y = lrn_f32(xf, radius=radius, alpha=alpha, beta=beta, bias=bias)
    y = torch.round(y / build.scalar(build.f32(s_out), x_q.device))
    return torch.clamp(y, -127, 127).to(torch.int8)


@functools.lru_cache(maxsize=256)
def _kernel_scalars(s_in, s_out, alpha, bias, beta) -> tuple:
    """The kernel's scalar arguments: s_in, s_out, alpha, bias as f32,
    whether beta is 0.75, beta as f32."""
    return (build.f32(s_in), build.f32(s_out), build.f32(alpha), build.f32(bias),
            int(_beta_is_075(beta)), build.f32(beta))


def qlrn(x_q: torch.Tensor, *, radius: int, alpha: float, beta: float, bias: float,
         s_in: float, s_out: float, slow_count: torch.Tensor | None = None) -> torch.Tensor:
    """x_q (..., C) int8 -> int8 of the same shape. Raises on a CUDA tensor
    the kernel does not take (``covers``: more channels than one block's
    shared memory holds). ``slow_count``, an int32 tensor of one element on
    the card, gains the number of elements the kernel took through the
    exact steps (every element where beta is not 0.75)."""
    kw = dict(radius=radius, alpha=alpha, beta=beta, bias=bias, s_in=s_in, s_out=s_out)
    if x_q.device.type == "cpu":
        return qlrn_plain(x_q, **kw)
    c = x_q.shape[-1]
    m = x_q.numel() // c
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, tuple(x_q.shape)))
    if not covers(c, max_channels()):
        raise ValueError(f"qlrn kernel: {c} channels, at most {max_channels()}")
    if slow_count is not None:
        build.check_operands(x_q.device, slow_count=(slow_count, torch.int32, (1,)))
    y = torch.empty_like(x_q)
    rc = _lib().tf2_qlrn(x_q.data_ptr(), y.data_ptr(), m, c, radius,
                         *_kernel_scalars(s_in, s_out, alpha, bias, beta), CERT_REL,
                         None if slow_count is None else slow_count.data_ptr(),
                         build.raw_stream(x_q.device))
    build.check_launch(rc, "qlrn")
    LAUNCHES["qlrn"] += 1
    return y


def fused_qlrn(x_q: torch.Tensor, *, plain: bool = False, **kw) -> torch.Tensor:
    """Dispatch entry: the kernel, or its plain version when ``plain``."""
    return qlrn_plain(x_q, **kw) if plain else qlrn(x_q, **kw)
