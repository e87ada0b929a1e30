"""Fused int8 attention core: packed qkv (N, T, 3 * dim) int8 in, (N, T, dim)
int8 out, per head (hd = dim / heads):

    acc    = Q K^T                               int8 x int8 -> int32, exact
    logits = f32(acc) * qk_scale,  qk_scale = f32(f32(s_in^2) / f32(sqrt(hd)))
    e      = f32(exp(f64(logits - rowmax)))      the exp in float64, rounded once
    p      = e / f32(sum_f64(e))                 the row sum in float64, rounded once
    p_q    = round(p * 127)                      int8 in [0, 127]
    y      = clip(round(f32(p_q V) * pv_scale), +-127),  pv_scale = f32(s_in / (127 s_out))

which is what ``tf2_tpu/kernels/dispatch.py:294-335`` (the jnp path)
computes: probabilities are e / sum, then * 127, not the TPU kernel's
e * (127 / sum). The exp and the sum in float64 are the steps that matched
that path's f32 softmax element for element on the CPU tests' shapes.

``qattention`` launches ``csrc/qattention.cu`` on CUDA tensors and takes
the plain version (``qattention_plain``) on CPU tensors. The integer
products are exact in any order and every f32 step is one correctly
rounded operation; the float64 exp is the same function in the kernel and
in ``torch.exp`` on the card, and the float64 row sum, rounded once to f32,
differs between orders only when it lies within a few double ulps of an
f32 rounding boundary. The kernel takes hd a multiple of 16 up to 128 and
any N and T (``covers``): its logits stay in registers, a chunk of keys at
a time, and a sequence whose K and V do not fit one block's shared memory
streams through it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

LAUNCHES = {"qattention": 0}
_SIG = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("qattention.cu")
    lib.tf2_qattention.argtypes, lib.tf2_qattention.restype = _SIG, ctypes.c_int
    return lib


def covers(t: int, hd: int) -> bool:
    """Does the kernel take a sequence of ``t`` tokens at head width
    ``hd``? Any t >= 1 at hd a multiple of 16 up to 128."""
    return t >= 1 and 16 <= hd <= 128 and hd % 16 == 0


def scales(heads: int, dim: int, s_in: float, s_out: float) -> tuple[float, float]:
    """(qk_scale, pv_scale) as f32, formed as the reference forms them:
    f32(s_in * s_in) / sqrt(f32(hd)) as an f32 division, and the double
    s_in / (127 * s_out) rounded once."""
    hd = np.float32(dim // heads)
    qk = np.float32(np.float32(s_in * s_in) / np.sqrt(hd))
    return float(qk), float(np.float32(s_in / (127.0 * s_out)))


def qattention_plain(qkv_q: torch.Tensor, *, heads: int, dim: int, s_in: float,
                     s_out: float) -> torch.Tensor:
    """Plain version of the kernel, on any device (``meta`` too). The
    products are summed in float64, where they are exact integers."""
    n, t, _ = qkv_q.shape
    hd = dim // heads
    qk_scale, pv_scale = scales(heads, dim, s_in, s_out)
    q, k, v = (z.reshape(n, t, heads, hd).transpose(1, 2).to(torch.float64)
               for z in torch.split(qkv_q, dim, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) * qk_scale
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp((logits - m).to(torch.float64)).to(torch.float32)
    total = e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
    p_q = torch.round((e / total) * 127.0)
    acc = torch.matmul(p_q.to(torch.float64), v).to(torch.float32)
    y = torch.clamp(torch.round(acc * pv_scale), -127, 127).to(torch.int8)
    return y.transpose(1, 2).reshape(n, t, dim)


def qattention(qkv_q: torch.Tensor, *, heads: int, dim: int, s_in: float, s_out: float,
               fallbacks: torch.Tensor | None = None) -> torch.Tensor:
    """qkv_q (N, T, 3 * dim) int8 -> (N, T, dim) int8. Raises on a CUDA
    tensor the kernel does not take (``covers``: hd not a multiple of 16 or
    above 128; a start not 16-byte aligned). ``fallbacks``, a (1,) int64
    tensor on the card, gets the number of elements whose division took
    the kernel's exact steps (its certified fast path flagged them) added
    to it."""
    if qkv_q.device.type == "cpu":
        return qattention_plain(qkv_q, heads=heads, dim=dim, s_in=s_in, s_out=s_out)
    n, t, three_dim = qkv_q.shape
    if three_dim != 3 * dim or dim % heads:
        raise ValueError(f"qattention: qkv {tuple(qkv_q.shape)} with dim {dim}, {heads} heads")
    build.check_operands(qkv_q.device, qkv_q=(qkv_q, torch.int8, (n, t, 3 * dim)))
    hd = dim // heads
    if not covers(t, hd):
        raise ValueError(f"qattention kernel: head width {hd} and {t} tokens, needs a "
                         "multiple of 16 up to 128 and at least one token")
    if qkv_q.data_ptr() % 16:
        raise ValueError("qattention kernel: qkv does not start on a 16-byte boundary")
    if fallbacks is not None:
        build.check_operands(qkv_q.device, fallbacks=(fallbacks, torch.int64, (1,)))
    y = torch.empty((n, t, dim), dtype=torch.int8, device=qkv_q.device)
    qk_scale, pv_scale = scales(heads, dim, s_in, s_out)
    rc = _lib().tf2_qattention(qkv_q.data_ptr(), y.data_ptr(), n, t, heads, hd,
                               qk_scale, pv_scale,
                               None if fallbacks is None else fallbacks.data_ptr(),
                               build.raw_stream(qkv_q.device))
    build.check_launch(rc, "qattention")
    LAUNCHES["qattention"] += 1
    return y


def fused_qattention(qkv_q: torch.Tensor, *, plain: bool = False, **kw) -> torch.Tensor:
    """Dispatch entry: the kernel, or its plain version when ``plain``."""
    return qattention_plain(qkv_q, **kw) if plain else qattention(qkv_q, **kw)
