"""Fused shift-quantized matmul: x (M, K) int8 . W (K, N) -> requant -> int8.

``qmatmul_pot4`` takes W as split-half packed 4-bit PoT codes (K/2, N) and
decodes them on chip; ``qmatmul_int8`` takes int8 W (K, N) and, optionally,
a residual (an int8 (M, N) tensor and its f32 scale) added in the epilogue.
Both launch the CUDA kernels of ``csrc/shift_matmul.cu`` on CUDA tensors
and take their plain versions (``*_plain``) on CPU tensors. The plain
versions decode the codes, accumulate exactly in float64 and apply the same
f32 epilogue op for op; torch's int8 matmul on the CPU returns int8 and
wraps, so it is not used.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..transform import potq
from . import build

LAUNCHES = {"qmatmul_pot4": 0, "qmatmul_int8": 0}
_SIG_POT4 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SIG_INT8 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("shift_matmul.cu")
    lib.tf2_qmatmul_pot4.argtypes, lib.tf2_qmatmul_pot4.restype = _SIG_POT4, ctypes.c_int
    lib.tf2_qmatmul_int8.argtypes, lib.tf2_qmatmul_int8.restype = _SIG_INT8, ctypes.c_int
    return lib


def epilogue(acc: torch.Tensor, eff_scale: torch.Tensor, eff_bias: torch.Tensor,
             relu: bool, residual=None) -> torch.Tensor:
    """int32 accumulator -> int8: clip(round(max?(f32(acc) * es + eb)), +-127),
    the multiply and the add rounded separately. ``residual`` (r_q, scale):
    + f32(r_q) * f32(scale) after eb, as a third rounded step."""
    y = acc.to(torch.float32) * eff_scale + eff_bias
    if residual is not None:
        r_q, scale = residual
        y = y + r_q.to(torch.float32) * build.f32(scale)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def qmatmul_int8_plain(x_q, w_q, eff_scale, eff_bias, relu: bool = False, residual=None):
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    # the sum is exact in float64; rounding before the cast keeps it exact
    # whichever algorithm the device's library picks
    return epilogue(acc.round().to(torch.int32), eff_scale, eff_bias, relu, residual)


def qmatmul_pot4_plain(x_q, packed, eff_scale, eff_bias, relu: bool = False, residual=None):
    w_q = potq.pot_decode(potq.unpack_codes(packed, x_q.shape[1]))
    return qmatmul_int8_plain(x_q, w_q, eff_scale, eff_bias, relu, residual)


def _launch(kernel: str, x_q, w, w_shape, w_dtype, eff_scale, eff_bias, relu, residual=None):
    m, k = x_q.shape
    n = w_shape[1]
    operands = dict(x_q=(x_q, torch.int8, (m, k)), w=(w, w_dtype, w_shape),
                    eff_scale=(eff_scale, torch.float32, (n,)),
                    eff_bias=(eff_bias, torch.float32, (n,)))
    if residual is not None:
        operands["residual"] = (residual[0], torch.int8, (m, n))
    build.check_operands(x_q.device, **operands)
    y = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    ptrs = [x_q.data_ptr(), w.data_ptr(), eff_scale.data_ptr(), eff_bias.data_ptr()]
    if kernel == "qmatmul_pot4":
        rc = _lib().tf2_qmatmul_pot4(*ptrs, y.data_ptr(), m, n, k, int(relu), stream)
    else:
        r_ptr, scale = (None, 0.0) if residual is None else (residual[0].data_ptr(), residual[1])
        rc = _lib().tf2_qmatmul_int8(*ptrs, r_ptr, y.data_ptr(), m, n, k, int(relu),
                                     build.f32(scale), stream)
    build.check_launch(rc, kernel)
    LAUNCHES[kernel] += 1
    return y


def qmatmul_pot4(x_q: torch.Tensor, packed: torch.Tensor, eff_scale: torch.Tensor,
                 eff_bias: torch.Tensor, relu: bool = False, residual=None) -> torch.Tensor:
    """x_q (M, K) int8 . packed (K/2, N) uint8 -> (M, N) int8. The kernel
    has no residual epilogue: on the card a residual raises (the Engine
    decodes such weights to int8 at load)."""
    m, k = x_q.shape
    if k % 2 or packed.shape[0] * 2 != k:
        raise ValueError(f"split-half packing mismatch: K={k} rows={packed.shape[0]}")
    if x_q.device.type == "cpu":
        return qmatmul_pot4_plain(x_q, packed, eff_scale, eff_bias, relu, residual)
    if residual is not None:
        raise ValueError("qmatmul_pot4 kernel: no residual epilogue; decode the "
                         "weights to int8 for qmatmul_int8")
    return _launch("qmatmul_pot4", x_q, packed, (k // 2, packed.shape[1]),
                   torch.uint8, eff_scale, eff_bias, relu)


def qmatmul_int8(x_q: torch.Tensor, w_q: torch.Tensor, eff_scale: torch.Tensor,
                 eff_bias: torch.Tensor, relu: bool = False, residual=None) -> torch.Tensor:
    """x_q (M, K) int8 . w_q (K, N) int8 -> (M, N) int8; ``residual`` is
    (r_q (M, N) int8, its scale) or None."""
    if x_q.device.type == "cpu":
        return qmatmul_int8_plain(x_q, w_q, eff_scale, eff_bias, relu, residual)
    return _launch("qmatmul_int8", x_q, w_q, (x_q.shape[1], w_q.shape[1]),
                   torch.int8, eff_scale, eff_bias, relu, residual)


def fused_qmatmul(x_q, wparam, eff_scale, eff_bias, relu: bool, wfmt: str,
                  plain: bool = False, residual=None) -> torch.Tensor:
    """Dispatch entry: the kernel for ``wfmt`` ("pot4" packed codes or
    "int8" (K, N) weights), or its plain version when ``plain``."""
    if wfmt == "pot4":
        fn = qmatmul_pot4_plain if plain else qmatmul_pot4
    else:
        fn = qmatmul_int8_plain if plain else qmatmul_int8
    return fn(x_q, wparam, eff_scale, eff_bias, relu, residual)
