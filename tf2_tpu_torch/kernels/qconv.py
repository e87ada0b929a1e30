"""Fused shift-quantized k x k conv: NHWC int8 x HWIO weights -> requant ->
NHWC int8.

``qconv_s1``, ``qconv_s2`` and ``qconv_s2x1`` launch the stride (1, 1),
(2, 2) and (2, 1) entry points of ``csrc/qconv.cu`` on CUDA tensors, an
implicit GEMM over the unpadded image with TF-SAME pads applied inside the
kernel; on CPU tensors they take the plain version (``qconv_plain``:
explicit ``F.pad``, exact float64 ``F.conv2d``, the same f32 epilogue).
Stride (2, 1) is the W-pair-packed stem (``wpack2``, dispatch.qconv2d).
``fused_qconv2d`` is the dispatch entry: ungrouped 1x1 stride-1 convs go to
the GEMM kernels of ``shift_matmul``; a conv the kernels do not take
(``covers``: grouped, or another stride) runs its plain version on the CPU
and raises on the card, where the Engine's coverage plan sends it to the
plain version at load (``runtime/engine.py``), as the reference sends it
to XLA.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..transform import potq
from . import build, shift_matmul

LAUNCHES = {"qconv_s1": 0, "qconv_s2": 0, "qconv_s2x1": 0}
_KERNELS = {(1, 1): "qconv_s1", (2, 2): "qconv_s2", (2, 1): "qconv_s2x1"}
_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("qconv.cu")
    for kernel in _KERNELS.values():
        fn = getattr(lib, f"tf2_{kernel}")
        fn.argtypes, fn.restype = _SIG, ctypes.c_int
    return lib


def _pad_amount(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF-style SAME padding: (before, after), the extra pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def resolve_pads(padding, kh: int, kw: int, sh: int, sw: int, h: int, w: int):
    """-> ((ph0, ph1), (pw0, pw1)) for SAME/VALID/explicit paddings."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        return _pad_amount(h, kh, sh), _pad_amount(w, kw, sw)
    (ph0, ph1), (pw0, pw1) = padding
    return (ph0, ph1), (pw0, pw1)


def out_size(size: int, k: int, s: int, p0: int, p1: int) -> int:
    return (size + p0 + p1 - k) // s + 1


def covers(kshape, strides, groups: int) -> bool:
    """Do the conv kernels take this conv? Ungrouped, strides (1, 1),
    (2, 2) or (2, 1). (The Engine's predecode and its coverage plan ask the
    same question.)"""
    return groups == 1 and tuple(strides) in _KERNELS


def decode_hwio(wparam: torch.Tensor, wfmt: str, kshape) -> torch.Tensor:
    """Packed pot4 (K/2, N) or int8 weights -> int8 HWIO."""
    if wfmt == "pot4":
        k = kshape[0] * kshape[1] * kshape[2]
        return potq.pot_decode(potq.unpack_codes(wparam, k)).reshape(kshape)
    return wparam.reshape(kshape)


def qconv_plain(x_q, wparam, eff_scale, eff_bias, *, strides: tuple[int, int], kshape,
                pads, relu: bool, wfmt: str, groups: int = 1):
    """Plain version of the conv kernels, and of any conv they do not take:
    ``strides`` (sh, sw), ``kshape`` (kh, kw, cin / groups, cout)."""
    (ph0, ph1), (pw0, pw1) = pads
    w = decode_hwio(wparam, wfmt, kshape)
    xp = F.pad(x_q.permute(0, 3, 1, 2).to(torch.float64), (pw0, pw1, ph0, ph1))
    acc = F.conv2d(xp, w.permute(3, 2, 0, 1).to(torch.float64), stride=tuple(strides),
                   groups=groups)
    # the sum is exact in float64; rounding before the cast keeps it exact
    # whichever algorithm cuDNN picks on the card
    acc = acc.permute(0, 2, 3, 1).contiguous().round().to(torch.int32)
    return shift_matmul.epilogue(acc, eff_scale, eff_bias, relu)


def _qconv(strides: tuple[int, int], x_q, wparam, eff_scale, eff_bias, *, kshape, pads,
           relu: bool, wfmt: str):
    if x_q.device.type == "cpu":
        return qconv_plain(x_q, wparam, eff_scale, eff_bias, strides=strides,
                           kshape=kshape, pads=pads, relu=relu, wfmt=wfmt)
    sh, sw = strides
    kh, kw, cin, cout = kshape
    b, h, w, _ = x_q.shape
    (ph0, ph1), (pw0, pw1) = pads
    oh, ow = out_size(h, kh, sh, ph0, ph1), out_size(w, kw, sw, pw0, pw1)
    k = kh * kw * cin
    if wfmt == "pot4":
        if k % 2:
            raise ValueError(f"pot4 conv needs an even K, got {k}")
        wshape, wdtype = (k // 2, cout), torch.uint8
    else:
        wshape, wdtype = tuple(kshape), torch.int8
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, (b, h, w, cin)),
                         w=(wparam, wdtype, wshape),
                         eff_scale=(eff_scale, torch.float32, (cout,)),
                         eff_bias=(eff_bias, torch.float32, (cout,)))
    if oh < 1 or ow < 1:
        raise ValueError(f"empty conv output {oh}x{ow}")
    kernel = _KERNELS[(sh, sw)]
    y = torch.empty((b, oh, ow, cout), dtype=torch.int8, device=x_q.device)
    rc = getattr(_lib(), f"tf2_{kernel}")(
        x_q.data_ptr(), wparam.data_ptr(), eff_scale.data_ptr(),
        eff_bias.data_ptr(), y.data_ptr(), b, h, w, cin, oh, ow, kh, kw, ph0, pw0,
        cout, int(wfmt == "pot4"), int(relu),
        torch.cuda.current_stream(x_q.device).cuda_stream)
    build.check_launch(rc, kernel)
    LAUNCHES[kernel] += 1
    return y


def qconv_s1(x_q, wparam, eff_scale, eff_bias, *, kshape, pads, relu: bool,
             wfmt: str) -> torch.Tensor:
    """Stride-1 conv. x_q (B, H, W, C) int8 unpadded; wparam pot4 (K/2, N)
    uint8 or int8 HWIO; pads ((top, bottom), (left, right))."""
    return _qconv((1, 1), x_q, wparam, eff_scale, eff_bias, kshape=kshape, pads=pads,
                  relu=relu, wfmt=wfmt)


def qconv_s2(x_q, wparam, eff_scale, eff_bias, *, kshape, pads, relu: bool,
             wfmt: str) -> torch.Tensor:
    """Stride-2 conv, same contract as ``qconv_s1``."""
    return _qconv((2, 2), x_q, wparam, eff_scale, eff_bias, kshape=kshape, pads=pads,
                  relu=relu, wfmt=wfmt)


def qconv_s2x1(x_q, wparam, eff_scale, eff_bias, *, kshape, pads, relu: bool,
               wfmt: str) -> torch.Tensor:
    """Stride 2 along H and 1 along W (the ``wpack2`` stem), same contract
    as ``qconv_s1``."""
    return _qconv((2, 1), x_q, wparam, eff_scale, eff_bias, kshape=kshape, pads=pads,
                  relu=relu, wfmt=wfmt)


def fused_qconv2d(x_q: torch.Tensor, wparam: torch.Tensor, eff_scale, eff_bias,
                  strides, padding, groups: int, relu: bool, wfmt: str,
                  kshape, plain: bool = False) -> torch.Tensor:
    """x_q NHWC int8 -> NHWC int8 through the kernel for this shape, or its
    plain version when ``plain`` or on a CPU tensor. Raises on a CUDA
    tensor the kernels do not take (``covers``)."""
    kh, kw, _, cout = kshape
    strides = tuple(strides)
    b, h, w, cin = x_q.shape
    pads = resolve_pads(padding, kh, kw, *strides, h, w)
    if groups == 1 and (kh, kw) + strides == (1, 1, 1, 1) and pads == ((0, 0), (0, 0)):
        # a 1x1 stride-1 conv is a GEMM over the B*H*W pixels
        if wfmt == "int8":
            wparam = wparam.reshape(cin, cout)
        y = shift_matmul.fused_qmatmul(x_q.reshape(b * h * w, cin), wparam, eff_scale,
                                       eff_bias, relu, wfmt, plain)
        return y.reshape(b, h, w, cout)
    if plain or x_q.device.type == "cpu":
        return qconv_plain(x_q, wparam, eff_scale, eff_bias, strides=strides,
                           kshape=kshape, pads=pads, relu=relu, wfmt=wfmt, groups=groups)
    if not covers(kshape, strides, groups):
        raise NotImplementedError(
            f"conv kernels: kshape={kshape} strides={strides} groups={groups} not taken")
    return _qconv(strides, x_q, wparam, eff_scale, eff_bias, kshape=kshape, pads=pads,
                  relu=relu, wfmt=wfmt)
