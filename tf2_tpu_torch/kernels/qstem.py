"""Fused small-cin stride-2 stem conv: odd k x k, stride 2, cin <= 4 (the
ResNet/GoogLeNet 7x7 and the SqueezeNet/SSD 3x3 image stems), NHWC f32
image (quantized by ``scale``) or int8 image in, NHWC int8 out.

``qstem`` launches ``csrc/qstem.cu`` on CUDA tensors and takes the plain
version (``qstem_plain``: quantize, exact float64 conv, the f32 epilogue of
``qconv``) on CPU tensors; both take the weight folded by ``fold_weight``.
``fused_qstem`` is the entry, with the reference's contract: HWIO int8
weights, ``None`` on a shape ``covers`` refuses. No Engine routes a stem
here, in this package or in the reference.

``stem_geometry``, ``fold_image``, ``stem_taps``, ``fold_weight`` and
``covers`` are those of ``tf2_tpu/kernels/qstem.py``: its TPU kernel reads
the image folded into stride-2 phase planes (``fold_image``) because Mosaic
has no strided loads. The CUDA kernel reads the image as it is and needs
only ``fold_weight``'s (c, dy, dx) row order; ``fold_image`` and the
geometry's fold sizes stay so that ``covers`` keeps the reference's truth
table, its VMEM limit included.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import build, qconv
from .dispatch import quantize

LAUNCHES = {"qstem": 0}
_SIG = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 14
        + [ctypes.c_void_p])
_TILE_PIXELS = 512  # output pixels a block's band aims at


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("qstem.cu")
    lib.tf2_qstem.argtypes, lib.tf2_qstem.restype = _SIG, ctypes.c_int
    lib.tf2_qstem_fits.argtypes, lib.tf2_qstem_fits.restype = [ctypes.c_int] * 7, ctypes.c_int
    return lib


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _norm_padding(padding):
    if isinstance(padding, str):
        return padding
    return tuple(tuple(p) for p in padding)


@functools.lru_cache(maxsize=None)
def stem_geometry(h: int, w: int, kh: int, kw: int, padding="SAME") -> dict:
    """Pads, output size and the TPU fold's sizes of a kh x kw stride-2
    conv on an (h, w) image: ``prows`` phase rows (the last 32-row block's
    window), ``qcols`` phase columns, ``qp`` those rounded to 128 lanes."""
    (ph0, ph1), (pw0, pw1) = qconv.resolve_pads(padding, kh, kw, 2, 2, h, w)
    oh = (h + ph0 + ph1 - kh) // 2 + 1
    ow = (w + pw0 + pw1 - kw) // 2 + 1
    prows = _round_up(oh, 32) + (kh - 1) // 2
    qcols = ow + (kw - 1) // 2
    return dict(ph0=ph0, pw0=pw0, oh=oh, ow=ow, prows=prows, qcols=qcols,
                qp=_round_up(qcols, 128), dymax=(kh - 1) // 2, dxmax=(kw - 1) // 2)


def fold_image(x: torch.Tensor, kh: int, kw: int, padding="SAME",
               scale: float | None = None) -> torch.Tensor:
    """(B, H, W, C) (f32 with ``scale``, else int8) -> the reference's int8
    phase fold (B, 2C, PROWS, 2 * QP + 128): planes (c, hp), lanes (wp, q),
    q padded to QP, one more zero 128-lane tile. Input row r = 2p + hp and
    column 2q + wp of the padded image."""
    b, h, w, c = x.shape
    g = stem_geometry(h, w, kh, kw, _norm_padding(padding))
    if scale is not None:
        x = quantize(x, scale)
    hp_ext, wp_ext = 2 * g["prows"], 2 * g["qcols"]
    bottom = max(0, hp_ext - g["ph0"] - h)
    right = max(0, wp_ext - g["pw0"] - w)
    xp = F.pad(x, (0, 0, g["pw0"], right, g["ph0"], bottom))[:, :hp_ext, :wp_ext, :]
    xf = xp.reshape(b, g["prows"], 2, g["qcols"], 2, c).permute(0, 5, 2, 1, 4, 3)
    xf = F.pad(xf, (0, g["qp"] - g["qcols"]))
    return F.pad(xf.reshape(b, 2 * c, g["prows"], 2 * g["qp"]), (0, 128))


@functools.lru_cache(maxsize=None)
def stem_taps(kh: int, kw: int, cin: int) -> tuple:
    """Tap metadata in K order (c, dy, dx): (plane c * 2 + dy % 2, row
    shift dy // 2, lane half dx % 2, lane shift dx // 2)."""
    return tuple((c * 2 + dy % 2, dy // 2, dx % 2, dx // 2)
                 for c in range(cin) for dy in range(kh) for dx in range(kw))


def fold_weight(w_q) -> torch.Tensor:
    """(kh, kw, cin, cout) int8 -> (Kp, cout): rows in ``stem_taps`` order
    (c, dy, dx), K zero-padded to a multiple of 32 (147 -> 160 at 7x7x3,
    27 -> 32 at 3x3x3). On ``w_q``'s device."""
    w_q = torch.as_tensor(w_q)
    kh, kw, cin, cout = w_q.shape
    wmat = w_q.to(torch.int8).permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return F.pad(wmat, (0, 0, 0, _round_up(wmat.shape[0], 32) - wmat.shape[0]))


def covers(kshape, strides, padding, groups: int, xshape) -> bool:
    """The reference's truth table: ungrouped, strides (2, 2), odd square
    kernel, cin <= 4, a non-empty output, and the TPU fold within 4 MiB."""
    kh, kw, cin, cout = kshape
    if groups != 1 or len(xshape) != 4:
        return False
    if tuple(strides) != (2, 2) or kh != kw or kh % 2 == 0 or cin > 4:
        return False
    b, h, w, c = xshape
    g = stem_geometry(h, w, kh, kw, _norm_padding(padding))
    if g["oh"] < 1 or g["ow"] < 1:
        return False
    return 2 * cin * g["prows"] * 2 * g["qp"] <= 4 * 1024 * 1024


def _unfold_weight(wmat: torch.Tensor, kh: int, kw: int, cin: int) -> torch.Tensor:
    """``fold_weight``'s inverse: (Kp, cout) -> HWIO."""
    return wmat[:cin * kh * kw].reshape(cin, kh, kw, -1).permute(1, 2, 0, 3)


def qstem_plain(x: torch.Tensor, wmat: torch.Tensor, eff_scale, eff_bias, *, kh: int,
                kw: int, padding, relu: bool, scale: float | None = None) -> torch.Tensor:
    """Plain version of the kernel: quantize (with ``scale``), then the
    stride-2 conv of the unfolded weight with the geometry's pads."""
    b, h, w, cin = x.shape
    x_q = quantize(x, scale) if scale is not None else x
    pads = qconv.resolve_pads(_norm_padding(padding), kh, kw, 2, 2, h, w)
    w_q = _unfold_weight(wmat, kh, kw, cin)
    return qconv.qconv_plain(x_q, w_q, eff_scale, eff_bias, strides=(2, 2),
                             kshape=tuple(w_q.shape), pads=pads, relu=relu, wfmt="int8")


def band_rows(batch: int, oh: int, ow: int) -> int:
    """Output rows a block takes: about ``_TILE_PIXELS`` pixels, halved while
    the grid would leave most of the card's 132 SMs without two blocks."""
    br = max(1, min(oh, _TILE_PIXELS // ow))
    while br > 1 and batch * -(-oh // br) < 2 * 132:
        br //= 2
    return br


def qstem(x: torch.Tensor, wmat: torch.Tensor, eff_scale, eff_bias, *, kh: int, kw: int,
          padding, relu: bool, scale: float | None = None) -> torch.Tensor:
    """x (B, H, W, cin) f32 with ``scale`` or int8 without; wmat (Kp, cout)
    from ``fold_weight`` -> (B, OH, OW, cout) int8. Raises on a CUDA shape
    whose block does not fit the card's shared memory."""
    if x.device.type == "cpu":
        return qstem_plain(x, wmat, eff_scale, eff_bias, kh=kh, kw=kw, padding=padding,
                           relu=relu, scale=scale)
    b, h, w, cin = x.shape
    kp, cout = wmat.shape
    g = stem_geometry(h, w, kh, kw, _norm_padding(padding))
    oh, ow = g["oh"], g["ow"]
    xdtype = torch.int8 if scale is None else torch.float32
    build.check_operands(x.device, x=(x, xdtype, (b, h, w, cin)), w=(wmat, torch.int8, (kp, cout)),
                         eff_scale=(eff_scale, torch.float32, (cout,)),
                         eff_bias=(eff_bias, torch.float32, (cout,)))
    if kp % 32 or kp < cin * kh * kw:
        raise ValueError(f"qstem: weight rows {kp} for K = {cin * kh * kw}")
    br = band_rows(b, oh, ow)
    if not _lib().tf2_qstem_fits(cin, ow, kh, kw, cout, kp, br):
        raise ValueError(f"qstem kernel: a block for {tuple(x.shape)}, k {kh}, cout {cout} "
                         "does not fit the card's shared memory")
    y = torch.empty((b, oh, ow, cout), dtype=torch.int8, device=x.device)
    rc = _lib().tf2_qstem(x.data_ptr(), wmat.data_ptr(), eff_scale.data_ptr(),
                          eff_bias.data_ptr(), y.data_ptr(), int(scale is not None),
                          build.f32(scale or 1.0), b, h, w, cin, oh, ow, kh, kw, g["ph0"],
                          g["pw0"], cout, kp, br, int(relu),
                          build.raw_stream(x.device))
    build.check_launch(rc, "qstem")
    LAUNCHES["qstem"] += 1
    return y


def fused_qstem(x: torch.Tensor, w_q, eff_scale, eff_bias, *, padding, relu: bool,
                scale: float | None = None, plain: bool = False):
    """Quantize (with ``scale``) and the stem conv. x (B, H, W, C) f32 with
    ``scale`` or int8; w_q HWIO int8. -> NHWC int8 (B, OH, OW, cout), or
    None where ``covers`` refuses the shape; the plain version when
    ``plain``."""
    kh, kw, cin, cout = tuple(w_q.shape)
    if not covers((kh, kw, cin, cout), (2, 2), padding, 1, tuple(x.shape)):
        return None
    wmat = fold_weight(w_q).to(x.device)
    es = torch.as_tensor(eff_scale, dtype=torch.float32).reshape(-1).to(x.device)
    eb = torch.as_tensor(eff_bias, dtype=torch.float32).reshape(-1).to(x.device)
    fn = qstem_plain if plain else qstem
    return fn(x, wmat, es, eb, kh=kh, kw=kw, padding=padding, relu=relu, scale=scale)
