"""Fused int8 layer norm: int8 rows (..., D) in, int8 out, in one pass.

Normalization is scale invariant, so the codes normalize directly with
eps / s_in^2; the affine and the output quantize fold into gamma / s_out
and beta / s_out:

    mu  = f32(S1 / D),  var = f32((D * S2 - S1^2) / D^2)
    y   = ((x - mu) * (1 / sqrt(var + f32(eps / s_in^2)))) * (gamma / s_out)
          + beta / s_out
    out = clip(rint(y), +-127)

S1 and S2, the sums of the codes and of their squares, are exact integers
in any order, and every other step is one IEEE operation (no fused
multiply-add), so the kernel, the plain version on the card and the plain
version on the CPU give the same bits. The variance is the exact one where
the reference (``tf2_tpu/kernels/dispatch.py:433-451``) takes f32 means
and ``rsqrt``: they agree to within one quantum at rounding boundaries.

``qlayernorm`` launches ``csrc/qlayernorm.cu`` on CUDA tensors (one warp a
row, the row's codes in registers for both passes) and takes the plain
version (``qlayernorm_plain``) on CPU tensors. The kernel takes widths D
that are a multiple of 8 up to ``MAX_WIDTH`` (``covers``); the Engine's
coverage plan leaves a node of any other width on the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LAUNCHES = {"qlayernorm": 0}
# the widest row the kernel takes: 16 8-byte words in each lane's registers
# (csrc/qlayernorm.cu: kMaxWidth, which tf2_qlayernorm_max_width reports)
MAX_WIDTH = 4096
# x, y, gamma, beta, m, d, eps, so, stream
_SIG = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 2
        + [ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("qlayernorm.cu")
    lib.tf2_qlayernorm.argtypes, lib.tf2_qlayernorm.restype = _SIG, ctypes.c_int
    lib.tf2_qlayernorm_max_width.argtypes = []
    lib.tf2_qlayernorm_max_width.restype = ctypes.c_int
    return lib


def max_width() -> int:
    """The widest row the kernel built for the card takes."""
    return _lib().tf2_qlayernorm_max_width()


def covers(d: int) -> bool:
    """Does the kernel take rows of ``d`` codes? A multiple of 8 (whole
    8-byte words) up to ``MAX_WIDTH``."""
    return 8 <= d <= MAX_WIDTH and d % 8 == 0


def qlayernorm_plain(x_q: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                     eps: float, s_in: float, s_out: float) -> torch.Tensor:
    """Plain version of the kernel, on any device (``meta`` too)."""
    gamma = gamma.to(torch.float32)
    beta = beta.to(torch.float32)
    d = x_q.shape[-1]
    dev = x_q.device
    xi = x_q.to(torch.int64)
    s1 = xi.sum(dim=-1, keepdim=True)
    s2 = (xi * xi).sum(dim=-1, keepdim=True)
    mu = (s1.to(torch.float64) / build.scalar(d, dev, torch.float64)).to(torch.float32)
    var = ((d * s2 - s1 * s1).to(torch.float64)
           / build.scalar(d * d, dev, torch.float64)).to(torch.float32)
    inv = build.scalar(1.0, dev) / build.sqrt_rn(var + _eps(eps, s_in))
    so = build.scalar(build.f32(s_out), dev)
    y = ((x_q.to(torch.float32) - mu) * inv) * (gamma / so) + beta / so
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def _eps(eps: float, s_in: float) -> float:
    """eps on the codes' scale, eps / s_in^2 in double, rounded once to f32."""
    return build.f32(eps / (s_in * s_in))


def qlayernorm(x_q: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, eps: float,
               s_in: float, s_out: float) -> torch.Tensor:
    """x_q (..., D) int8, gamma and beta (D,) f32 -> int8 of x_q's shape.
    Raises on a CUDA tensor the kernel does not take (``covers``, or rows
    not 8-byte aligned)."""
    if x_q.device.type == "cpu":
        return qlayernorm_plain(x_q, gamma, beta, eps=eps, s_in=s_in, s_out=s_out)
    d = x_q.shape[-1]
    if not covers(d):
        raise ValueError(f"qlayernorm kernel: rows of {d} codes, a multiple of 8 up to "
                         f"{MAX_WIDTH} taken")
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, tuple(x_q.shape)),
                         gamma=(gamma, torch.float32, (d,)), beta=(beta, torch.float32, (d,)))
    if x_q.data_ptr() % 8:
        raise ValueError("qlayernorm kernel: x_q is not 8-byte aligned")
    y = torch.empty_like(x_q)
    m = x_q.numel() // d
    if m == 0:
        return y
    rc = _lib().tf2_qlayernorm(x_q.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                               m, d, _eps(eps, s_in), build.f32(s_out),
                               build.raw_stream(x_q.device))
    build.check_launch(rc, "qlayernorm")
    LAUNCHES["qlayernorm"] += 1
    return y


def fused_qlayernorm(x_q: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                     plain: bool = False, **kw) -> torch.Tensor:
    """Dispatch entry: the kernel, or its plain version when ``plain``."""
    return (qlayernorm_plain if plain else qlayernorm)(x_q, gamma, beta, **kw)
