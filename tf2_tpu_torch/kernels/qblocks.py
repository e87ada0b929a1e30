"""Fused chain of stride-1 residual bottleneck blocks (ResNet's stage
interiors), each block

    h  = relu-requant(x . w1)                  1x1
    g  = relu-requant(conv3x3_SAME(h, w2))     zero pads
    y3 = requant(g . w3)                       1x1, no relu
    r  = x, or requant(x . wd)                 identity or 1x1 downsample
    x  = clip(rint(relu?(y3 * sa/so + r * sb/so)), +-127)

on NHWC int8. ``qblockchain`` launches ``csrc/qblocks.cu`` once per block
on CUDA tensors and takes the plain version (``qblockchain_plain``, built
from the port's exact conv/GEMM pieces) on CPU tensors. The c3 requant and
then the add's rounding are the reference's double rounding, reproduced
exactly by both.

A block's dict: ``w1`` (Cin, Cm), ``w2`` (3, 3, Cm, Cm), ``w3`` (Cm, Cout)
int8; ``es*``/``eb*`` f32 per channel; optional ``wd`` (Cin, Cout) with
``esd``/``ebd``; ``sa_over_so``/``sb_over_so`` (host floats, used as f32);
``relu`` for the add.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, qconv, shift_matmul

LAUNCHES = {"qblockchain": 0}
_SIG = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_void_p])

STAGE_BYTES = 2 * 64 * 80  # csrc/qblocks.cu: the staged A and B tiles, 64 rows of 80 B
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on sm_90
MAX_BAND = 8            # output rows per CTA, at most


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("qblocks.cu")
    lib.tf2_qblock.argtypes, lib.tf2_qblock.restype = _SIG, ctypes.c_int
    return lib


def qblockchain_plain(x_q: torch.Tensor, blocks) -> torch.Tensor:
    """Plain version: each conv through the port's exact float64 pieces,
    the same f32 epilogues and add."""
    for blk in blocks:
        b, h, w, cin = x_q.shape
        cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
        x2 = x_q.reshape(b * h * w, cin)
        hm = shift_matmul.qmatmul_int8_plain(x2, blk["w1"], blk["es1"], blk["eb1"], True)
        g = qconv.qconv_plain(hm.reshape(b, h, w, cm), blk["w2"], blk["es2"], blk["eb2"],
                              strides=(1, 1), kshape=(3, 3, cm, cm), pads=((1, 1), (1, 1)),
                              relu=True, wfmt="int8")
        y3 = shift_matmul.qmatmul_int8_plain(g.reshape(b * h * w, cm), blk["w3"],
                                             blk["es3"], blk["eb3"], False)
        if "wd" in blk:
            r = shift_matmul.qmatmul_int8_plain(x2, blk["wd"], blk["esd"], blk["ebd"], False)
        else:
            r = x2
        y = (y3.to(torch.float32) * build.f32(blk["sa_over_so"])
             + r.to(torch.float32) * build.f32(blk["sb_over_so"]))
        if blk["relu"]:
            y = torch.clamp_min(y, 0.0)
        x_q = torch.clamp(torch.round(y), -127, 127).to(torch.int8).reshape(b, h, w, cout)
    return x_q


def _padded(c: int) -> int:
    return -(-c // 32) * 32


def smem_bytes(h: int, w: int, cm: int, band: int) -> int:
    """Shared memory of one CTA of ``csrc/qblocks.cu``: c1's output on the
    band plus a one-row halo with a zero column each side, the 3x3's output
    on the band (both with pixel rows of round_up(Cm, 32) + 16 bytes), and
    the staged A and B tiles."""
    ps = _padded(cm) + 16
    return (band + 2) * (w + 2) * ps + band * w * ps + STAGE_BYTES


def band_rows(b: int, h: int, w: int, cm: int, sms: int) -> int:
    """Output rows per CTA: the most rows (up to MAX_BAND) that still give
    two CTAs per SM, else 1; fewer while the CTA's shared memory would not
    fit."""
    fits = [r for r in range(1, min(MAX_BAND, h) + 1) if smem_bytes(h, w, cm, r) <= SMEM_LIMIT]
    full = [r for r in fits if b * -(-h // r) >= 2 * sms]
    return max(full) if full else 1


def covers(shape, blocks, smem_limit: int = SMEM_LIMIT) -> bool:
    """Does the chain kernel take this chain? Every block's 3x3 output and
    c1 band fit one CTA's shared memory (``smem_limit``, the card's) at one
    output row, identity blocks keep the channel count, and each block
    reads the previous one's output."""
    _, h, w, cin = shape
    for blk in blocks:
        cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
        if blk["w1"].shape[0] != cin or smem_bytes(h, w, cm, 1) > smem_limit:
            return False
        if "wd" not in blk and cin != cout:
            return False
        cin = cout
    return True


def _check_block(dev, blk, cin: int) -> tuple[int, int]:
    cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
    ops = {"w1": (blk["w1"], torch.int8, (cin, cm)),
           "w2": (blk["w2"], torch.int8, (3, 3, cm, cm)),
           "w3": (blk["w3"], torch.int8, (cm, cout))}
    for k, n in (("1", cm), ("2", cm), ("3", cout)):
        ops["es" + k] = (blk["es" + k], torch.float32, (n,))
        ops["eb" + k] = (blk["eb" + k], torch.float32, (n,))
    if "wd" in blk:
        ops["wd"] = (blk["wd"], torch.int8, (cin, cout))
        ops["esd"] = (blk["esd"], torch.float32, (cout,))
        ops["ebd"] = (blk["ebd"], torch.float32, (cout,))
    build.check_operands(dev, **ops)
    return cm, cout


def qblockchain(x_q: torch.Tensor, blocks) -> torch.Tensor:
    """x_q (B, H, W, Cin) int8 -> (B, H, W, Cout) int8 through the chain.
    One kernel launch per block, output ping-ponging between two buffers,
    ``band_rows`` output rows per CTA. Raises on a CUDA chain the kernel
    does not take."""
    if x_q.device.type == "cpu":
        return qblockchain_plain(x_q, blocks)
    b, h, w, cin = x_q.shape
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, (b, h, w, cin)))
    if not covers(x_q.shape, blocks):
        raise ValueError(f"qblockchain: the chain kernel does not take this chain on "
                         f"{tuple(x_q.shape)}")
    sms = torch.cuda.get_device_properties(x_q.device).multi_processor_count
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    widest = max(blk["w3"].shape[1] for blk in blocks)
    bufs = [torch.empty(b * h * w * widest, dtype=torch.int8, device=x_q.device)
            for _ in range(min(2, len(blocks)))]
    for i, blk in enumerate(blocks):
        cm, cout = _check_block(x_q.device, blk, cin)
        y = bufs[i % 2][:b * h * w * cout].view(b, h, w, cout)
        down = "wd" in blk
        rc = _lib().tf2_qblock(
            x_q.data_ptr(), blk["w1"].data_ptr(), blk["es1"].data_ptr(), blk["eb1"].data_ptr(),
            blk["w2"].data_ptr(), blk["es2"].data_ptr(), blk["eb2"].data_ptr(),
            blk["w3"].data_ptr(), blk["es3"].data_ptr(), blk["eb3"].data_ptr(),
            blk["wd"].data_ptr() if down else None, blk["esd"].data_ptr() if down else None,
            blk["ebd"].data_ptr() if down else None, y.data_ptr(),
            b, h, w, cin, cm, cout, int(down), int(blk["relu"]),
            build.f32(blk["sa_over_so"]), build.f32(blk["sb_over_so"]),
            band_rows(b, h, w, cm, sms), stream)
        build.check_launch(rc, "qblockchain")
        x_q, cin = y, cout
    LAUNCHES["qblockchain"] += 1
    return x_q


def fused_qblockchain(x_q: torch.Tensor, blocks, plain: bool = False) -> torch.Tensor:
    """Dispatch entry: the chain kernel, or its plain version when
    ``plain``."""
    return qblockchain_plain(x_q, blocks) if plain else qblockchain(x_q, blocks)
