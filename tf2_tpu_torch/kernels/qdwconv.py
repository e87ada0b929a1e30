"""Fused int8 depthwise conv: NHWC int8 x (k, k, 1, C) int8 weights ->
requant -> NHWC int8, one k x k window a channel, stride 1, SAME pads.

``qdwconv`` launches ``csrc/qdwconv.cu`` on CUDA tensors (the window sums
on the tensor cores, each channel's window rows as banded matrices, 32
channels a block) and
takes the plain version (``qdwconv_plain``: ``qconv.qconv_plain`` with
``groups = C``, an exact float64 ``F.conv2d`` and the same f32 epilogue)
on any other device. The kernel takes k 3, 5 or 7, C a multiple of 8 and
int8 weights (``covers``); the Engine decodes a depthwise conv's 4-bit
codes at load (its K, k * k, is odd), and its plan leaves any other
grouped conv on the plain version. Its epilogue is
``shift_matmul.epilogue``'s, so the kernel, the plain version on the card
and the plain version on the CPU give the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, qconv

SOURCE = "qdwconv.cu"
LAUNCHES = {"qdwconv": 0}
KERNEL_SIZES = (3, 5, 7)
SMEM_LIMIT = 232448   # dynamic shared memory a block may have on sm_90
# x, w, es, eb, y, n, h, w, c, k, relu, stream
_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library(SOURCE)
    lib.tf2_qdwconv.argtypes, lib.tf2_qdwconv.restype = _SIG, ctypes.c_int
    lib.tf2_qdwconv_smem.argtypes, lib.tf2_qdwconv_smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    return lib


def _round_to(v: int, mod: int, rem: int) -> int:
    r = v - v % mod + rem
    return r if r >= v else r + mod


def smem_bytes(k: int, w: int) -> int:
    """Shared memory of a block over rows of ``w`` pixels (the layout of
    csrc/qdwconv.cu: 32 channel planes of 16 + k - 1 rows, 32 zero-padded
    weight rows of 32 bytes a window row, es and eb); ``tf2_qdwconv_smem``
    gives the kernel's own count."""
    rs = _round_to(8 * -(-w // 8) + 8, 32, 16)
    return 32 * ((16 + k - 1) * rs + 4 + 32 * k) + 2 * 32 * 4


def covers(kshape, strides, groups: int, cin: int, padding="SAME", width: int = 1) -> bool:
    """Does the kernel take this conv? A k x k depthwise conv (``groups =
    cin = cout``, one input channel a group) with k 3, 5 or 7, stride 1,
    SAME pads (or the same given explicitly), C a multiple of 8, on rows of
    ``width`` pixels whose block fits in shared memory."""
    kh, kw, cin_g, cout = kshape
    if not (kh == kw and kh in KERNEL_SIZES and cin_g == 1 and groups == cin == cout
            and cin % 8 == 0 and tuple(strides) == (1, 1)):
        return False
    p = (kh - 1) // 2
    if isinstance(padding, str):
        same = padding.upper() == "SAME"
    else:
        same = [tuple(q) for q in padding] == [(p, p), (p, p)]
    return same and smem_bytes(kh, width) <= SMEM_LIMIT


def _pads(k: int):
    p = (k - 1) // 2
    return (p, p), (p, p)


def qdwconv_plain(x_q: torch.Tensor, w_q: torch.Tensor, eff_scale, eff_bias, *,
                  relu: bool) -> torch.Tensor:
    """Plain version of the kernel, on any device (``meta`` too): the conv
    kernels' plain version with one group a channel."""
    k, c = w_q.shape[0], x_q.shape[-1]
    return qconv.qconv_plain(x_q, w_q, eff_scale, eff_bias, strides=(1, 1),
                             kshape=(k, k, 1, c), pads=_pads(k), relu=relu, wfmt="int8",
                             groups=c)


def qdwconv(x_q: torch.Tensor, w_q: torch.Tensor, eff_scale: torch.Tensor,
            eff_bias: torch.Tensor, *, relu: bool) -> torch.Tensor:
    """x_q (N, H, W, C) int8, w_q (k, k, 1, C) int8, eff_scale and eff_bias
    (C,) f32 -> (N, H, W, C) int8. Raises on a CUDA tensor the kernel does
    not take (``covers``, or tensors not aligned)."""
    if x_q.device.type != "cuda":
        return qdwconv_plain(x_q, w_q, eff_scale, eff_bias, relu=relu)
    n, h, w, c = x_q.shape
    k = w_q.shape[0]
    if not covers(tuple(w_q.shape), (1, 1), c, c, width=w):
        raise ValueError(f"qdwconv kernel: weight {tuple(w_q.shape)} on {c} channels, rows of "
                         f"{w}: k in {KERNEL_SIZES}, C a multiple of 8 taken")
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, (n, h, w, c)),
                         w_q=(w_q, torch.int8, (k, k, 1, c)),
                         eff_scale=(eff_scale, torch.float32, (c,)),
                         eff_bias=(eff_bias, torch.float32, (c,)))
    if x_q.data_ptr() % 4 or w_q.data_ptr() % 8:
        raise ValueError("qdwconv kernel: x_q is not 4-byte or w_q not 8-byte aligned")
    y = torch.empty_like(x_q)
    if x_q.numel() == 0:
        return y
    rc = _lib().tf2_qdwconv(x_q.data_ptr(), w_q.data_ptr(), eff_scale.data_ptr(),
                            eff_bias.data_ptr(), y.data_ptr(), n, h, w, c, k, int(relu),
                            build.raw_stream(x_q.device))
    build.check_launch(rc, "qdwconv")
    LAUNCHES["qdwconv"] += 1
    return y
