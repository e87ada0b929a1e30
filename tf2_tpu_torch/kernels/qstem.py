"""Fused small-cin stride-2 stem conv: odd k x k, stride 2, cin <= 4 (the
ResNet/GoogLeNet 7x7 and the SqueezeNet/SSD 3x3 image stems), NHWC f32
image (quantized by ``scale``) or int8 image in, NHWC int8 out.

``fused_qstem`` is the entry, with the reference's contract: HWIO int8
weights, ``None`` on a shape ``covers`` refuses. On CUDA tensors it
launches ``csrc/qstem.cu`` as ``plan`` lays the launch out; a stem that
``covers`` takes but ``plan`` has no launch for (k > 7, cout > 256, rows
that do not fit shared memory) runs the two passes the Engine keeps for
such stems, the quantize and the stride-2 conv kernel
(``qconv.fused_qconv2d``), counted in ``TWO_PASS``. On CPU tensors (and
with ``plain``) it takes the plain version (``qstem_plain``: quantize,
exact float64 conv, the f32 epilogue of ``qconv``). On the card the
Engine's plan (``dispatch.kernel_of``) sends here each zoo CNN's fused stem
that ``routes`` takes, and ``dispatch.prepare_weights`` gives its weight
the kernel's layout once (``prepare_weight``: (N, k * 32) rows in the (dy,
dx, c) order, each dy's taps padded to 32, seen through a view of the HWIO
shape). The wrapper lays each launch out once for each weight, image shape
and alignment, relu and scale (``_STEM_LAUNCHES``); a weight given
otherwise is prepared on the call and counted (``PREPARED_PER_CALL``). ``qstem`` is the kernel's entry on
``fold_weight``'s matrix, the reference's layout.

``stem_geometry``, ``fold_image``, ``stem_taps``, ``fold_weight`` and
``covers`` are those of ``tf2_tpu/kernels/qstem.py``: its TPU kernel reads
the image folded into stride-2 phase planes (``fold_image``) because Mosaic
has no strided loads. The CUDA kernel reads the image as it is; the fold's
sizes stay so that ``covers`` keeps the reference's truth table, its VMEM
limit included.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import build, dispatch, qconv

SOURCE = "qstem.cu"
LAUNCHES = {"qstem": 0}
# weights the wrapper prepared on a call, having been given none prepared;
# 0 on every Engine forward
PREPARED_PER_CALL = {"qstem": 0}
# calls of ``fused_qstem`` on the card that took the quantize and the
# stride-2 conv kernel, the stem having no launch of this kernel
TWO_PASS = {"qstem": 0}
KSTEP = 32            # reduction indices of one dy chunk: one k32 wgmma step
SMEM_LIMIT = 232448   # dynamic shared memory a block may have on sm_90
SMEM_SM = 233472      # shared memory of an SM; a block also takes 1 KB
H100_SMS = 132
BLOCKS_PER_SM = 2     # at most, by the registers of a block of two warpgroups (csrc/qstem.cu)


class StemLaunch(ctypes.Structure):
    """The arguments of one stem launch but the image and the output
    (``csrc/qstem.cu``: StemLaunch): the prepared weight's rows, es, eb,
    the scale and its reciprocal, the geometry and the plan."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("w", "es", "eb")]
                + [(f, ctypes.c_float) for f in ("scale", "rcp")]
                + [(f, ctypes.c_int) for f in (
                    "fast", "h", "w_", "c", "oh", "ow", "kh", "kw", "pad_top", "pad_left", "n",
                    "ldw", "relu", "f32", "cvec", "rs", "depth", "ns", "srow", "nr", "half",
                    "run_rows", "runs_per_image", "runs", "nchunks", "nw", "b0", "stage_bytes",
                    "ring_bytes", "b_bytes", "smem", "grid")])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library(SOURCE)
    lib.tf2_qstem.argtypes, lib.tf2_qstem.restype = [ctypes.c_void_p] * 4, ctypes.c_int
    lib.tf2_qstem_max_smem.argtypes, lib.tf2_qstem_max_smem.restype = [], ctypes.c_int
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
        x = dispatch.quantize(x, scale)
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
    x_q = dispatch.quantize(x, scale) if scale is not None else x
    pads = qconv.resolve_pads(_norm_padding(padding), kh, kw, 2, 2, h, w)
    w_q = _unfold_weight(wmat, kh, kw, cin)
    return qconv.qconv_plain(x_q, w_q, eff_scale, eff_bias, strides=(2, 2),
                             kshape=tuple(w_q.shape), pads=pads, relu=relu, wfmt="int8")


# ---- the kernel's weight layout ----

def prepare_weight(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO (kh, kw, cin, N) int8 -> the same values as an HWIO view of
    (N, kh * 32) rows: row n holds dy's taps (dx, c) at bytes 32 dy + dx cin
    + c, zero past kw cin (the kernel's B fragments, csrc/qstem.cu). Needs
    kw * cin <= 32."""
    kh, kw, cin, cout = w_q.shape
    if kw * cin > KSTEP:
        raise ValueError(f"qstem: kw * cin = {kw * cin} taps a row, at most {KSTEP}")
    rows = torch.zeros((cout, kh, KSTEP), dtype=torch.int8, device=w_q.device)
    rows[:, :, :kw * cin] = w_q.to(torch.int8).permute(3, 0, 1, 2).reshape(cout, kh, kw * cin)
    return rows.as_strided((kh, kw, cin, cout), (KSTEP, cin, 1, kh * KSTEP))


def prepared_ld(w: torch.Tensor) -> int | None:
    """The row stride (kh * 32) of ``w``'s rows if ``w`` is an int8 HWIO
    view in ``prepare_weight``'s layout that the kernel reads as it is
    (16-byte aligned, every row within the storage), else None."""
    if w.dim() != 4 or w.dtype != torch.int8:
        return None
    kh, kw, cin, cout = w.shape
    ld = kh * KSTEP
    if (kw * cin > KSTEP or w.data_ptr() % 16
            or any(w.stride(i) != s for i, s in enumerate((KSTEP, cin, 1, ld)) if w.shape[i] > 1)):
        return None
    return ld if w.untyped_storage().nbytes() >= w.storage_offset() + cout * ld else None


# ---- the launch plan ----
#
# csrc/qstem.cu: a block of two warpgroups, a producer and a consumer,
# walks runs of ``run_rows`` output rows of one image, ``rs`` rows a step.
# The producer brings a step's 2 rs new input rows through a staging ring
# ``depth`` steps ahead (a bulk copy a row where ``cvec`` is 16, else
# cp.async) and quantizes them into a ring of 4 rs + 2 k - 2
# int8 rows (two steps' rows, each kept twice, the second copy 2 bytes
# on, padded column 0 at byte ``b0``); the consumer takes the step's
# pixels 64 at a time against the output channels in ``nchunks`` chunks
# of ``nw`` (the wgmma's N, 32 or 64) and stores each lane's nw / 4
# channels of a pixel as one word.

@dataclass(frozen=True)
class Plan:
    """How one stem launches. ``cvec``: the staging copy width (16, 4, or 0:
    int8 rows the conversion reads straight from memory); ``runs`` runs of
    ``run_rows`` output rows (``runs_per_image`` an image) over ``grid``
    persistent blocks, at most ``blocks_per_sm`` an SM; ``eff``: the share
    of a step's 64-pixel tiles that hold pixels."""
    rs: int
    depth: int
    ns: int
    srow: int
    nr: int
    half: int
    run_rows: int
    runs_per_image: int
    runs: int
    nchunks: int
    nw: int
    b0: int
    cvec: int
    stage_bytes: int
    ring_bytes: int
    b_bytes: int
    smem: int
    grid: int
    blocks_per_sm: int
    eff: float

    @property
    def name(self) -> str:
        return (f"rs{self.rs} d{self.depth} run{self.run_rows} g{self.grid} n{self.nchunks}x"
                f"{self.nw} c{self.cvec}")


def ring_rows(rs: int, k: int) -> int:
    """Slots of the int8 ring: the rows of two steps (at most 2 rs + k - 2
    each, the first of a run included), the one the consumer reads and the
    one the producer writes."""
    return 4 * rs + 2 * k - 2


def smem_bytes(k: int, rs: int, depth: int, srow: int, half: int, cout: int, nw: int,
               staged: bool) -> tuple[int, int, int, int]:
    """(staging, ring, B, total) shared memory of a block (csrc/qstem.cu:
    the staging slots, the ring's slots of two copies each, B's 64-byte
    K-tiles of two dy for each channel chunk, es and eb, an mbarrier a
    staging slot), staging and ring 1024-byte aligned for B's swizzle."""
    ns = 2 * rs * depth + max(k - 2, 0) if staged else 0
    stage = _round_up(ns * srow, 1024)
    ring = _round_up(ring_rows(rs, k) * 2 * half, 1024)
    nchunks = -(-cout // nw)
    b = nchunks * ((k + 1) // 2) * nw * 64
    return stage, ring, b, stage + ring + b + 8 * nchunks * nw + 8 * ns


@functools.lru_cache(maxsize=512)
def plan(b: int, h: int, w: int, cin: int, cout: int, k: int, padding="SAME",
         f32: bool = True, x_align: int = 16, sms: int = H100_SMS,
         smem_limit: int = SMEM_LIMIT, rs: int | None = None,
         depth: int | None = None) -> Plan | None:
    """The launch of one stem, deterministic in its shape, input type, the
    image's address alignment, the card's SM count and shared memory; None
    where the kernel takes no launch (k > 7, kw * cin > 32, cout > 256, or
    nothing fits). ``rs``, ``depth``: a step other than the plan's own, for
    a sweep. The plan's own: among the steps of 1, 2 and 4 rows that fit
    with copies 2 or 1 steps ahead, the one whose pixels fill the most of
    the consumer's 64-pixel tiles, then the one that leaves room for two
    blocks an SM, then the deeper copies, then the more rows. Runs: as
    many an image as one wave of blocks holds at this batch (b64: 4 runs
    of 28 rows at 224x224; b1: one row each)."""
    g = stem_geometry(h, w, k, k, _norm_padding(padding))
    oh, ow = g["oh"], g["ow"]
    if k % 2 == 0 or k > 7 or k * cin > KSTEP or not 1 <= cin <= 4 or not 1 <= cout <= 256:
        return None
    if oh < 1 or ow < 1:
        return None
    nw = 32 if cout <= 32 else 64
    row_bytes = w * cin * (4 if f32 else 1)
    cvec = next((v for v in (16, 4) if row_bytes % v == 0 and x_align % v == 0), 0)
    srow = _round_up(row_bytes, 16)
    # padded column 0 at an even byte b0, and the image's first byte on a
    # 4-byte boundary where pw0 * cin is even (the producer's word stores)
    lead_bytes = g["pw0"] * cin
    b0 = 4 - lead_bytes % 4 if lead_bytes % 2 == 0 else 2
    half = _round_up(b0 + max((g["pw0"] + w) * cin, 2 * (ow - 1) * cin + KSTEP), 128) + 64
    best = None
    for rs_ in ((rs,) if rs else (1, 2, 4)):
        for depth_ in ((depth,) if depth else (2, 1)):
            stage, ring, bb, smem = smem_bytes(k, rs_, depth_, srow, half, cout, nw, cvec > 0)
            if smem > smem_limit:
                continue
            bps = max(1, min(BLOCKS_PER_SM, SMEM_SM // (smem + 1024)))
            per_image = max(1, min(oh, sms * bps // b))
            run_rows = -(-oh // per_image)
            if rs_ > run_rows and not rs:
                continue
            eff = rs_ * ow / (64 * -(-rs_ * ow // 64))
            key = (round(eff, 3), bps, depth_, rs_)
            if best is None or key > best[0]:
                runs = b * -(-oh // run_rows)
                best = (key, Plan(rs_, depth_, 2 * rs_ * depth_ + max(k - 2, 0) if cvec else 0,
                                  srow, ring_rows(rs_, k), half, run_rows, -(-oh // run_rows),
                                  runs, -(-cout // nw), nw, b0, cvec, stage, ring, bb, smem,
                                  min(runs, sms * bps), bps, eff))
    return None if best is None else best[1]


def routes(kshape, strides, padding, groups: int, xshape,
           smem_limit: int = SMEM_LIMIT) -> bool:
    """Does the Engine run this stem node on the kernel? ``covers`` takes
    it and ``plan`` has a launch for its f32 image (``dispatch.kernel_of``
    asks it, with the card's shared memory)."""
    kh, _, cin, cout = kshape
    if not covers(kshape, strides, padding, groups, xshape):
        return False
    b, h, w, _ = xshape
    return plan(b, h, w, cin, cout, kh, _norm_padding(padding), True,
                smem_limit=smem_limit) is not None


# ---- the wrapper ----

def _align(ptr: int) -> int:
    return min(16, ptr & -ptr) if ptr else 16


@functools.cache
def _card(device: torch.device) -> tuple[int, int]:
    """(SMs, dynamic shared memory a block may opt in to) of the card."""
    return (torch.cuda.get_device_properties(device).multi_processor_count,
            _lib().tf2_qstem_max_smem())


# The wrapper's launches, laid out once for each weight (the prepared
# weight, es and eb, by identity), image shape, dtype and alignment,
# padding, relu, scale and device: key -> (weak references to the three,
# their data pointers, the launch, the output's shape). An entry leaves
# with any of the three tensors, and is taken only while all three are
# alive and still at those pointers.
_STEM_LAUNCHES: dict[tuple, tuple] = {}


def _entry(key, x, w, es, eb, padding, relu: bool, scale) -> tuple:
    """Check every operand of a launch and lay it out; remembered in
    ``_STEM_LAUNCHES`` where the weight was given prepared (one prepared
    on the call is prepared, and counted, on every call)."""
    b, h, wd, cin = x.shape
    kh, kw, wcin, cout = w.shape
    f32 = scale is not None
    build.check_operands(x.device, x=(x, torch.float32 if f32 else torch.int8, (b, h, wd, cin)),
                         eff_scale=(es, torch.float32, (cout,)),
                         eff_bias=(eb, torch.float32, (cout,)))
    if w.device != x.device or w.dtype != torch.int8 or wcin != cin or kh != kw:
        raise ValueError(f"qstem: weight {tuple(w.shape)} {w.dtype} on {w.device} for an "
                         f"image {tuple(x.shape)} on {x.device}")
    sms, max_smem = _card(x.device)
    p = plan(b, h, wd, cin, cout, kh, padding, f32, _align(x.data_ptr()), sms,
             min(SMEM_LIMIT, max_smem))
    if p is None:
        raise ValueError(f"qstem kernel: no launch for {tuple(x.shape)}, k {kh}, cout {cout} "
                         "(k > 7, kw * cin > 32, cout > 256, or a block does not fit the "
                         "card's shared memory)")
    ld = prepared_ld(w)
    keep = ld is not None
    if not keep:
        w = prepare_weight(w)
        ld = kh * KSTEP
        PREPARED_PER_CALL["qstem"] += 1
    g = stem_geometry(h, wd, kh, kw, padding)
    s = build.f32(scale or 1.0)
    rcp = build.f32(1.0 / s)
    launch = StemLaunch(w.data_ptr(), es.data_ptr(), eb.data_ptr(), s, rcp,
                        int(np.isfinite(rcp) and 2.0 ** -126 <= rcp and 2.0 ** -126 <= s),
                        h, wd, cin, g["oh"], g["ow"], kh, kw, g["ph0"], g["pw0"], cout, ld,
                        int(relu), int(f32), p.cvec, p.rs, p.depth, p.ns, p.srow, p.nr,
                        p.half, p.run_rows, p.runs_per_image, p.runs, p.nchunks, p.nw, p.b0,
                        p.stage_bytes, p.ring_bytes, p.b_bytes, p.smem, p.grid)
    ptrs = (w.data_ptr(), es.data_ptr(), eb.data_ptr())
    out = (b, g["oh"], g["ow"], cout)
    if not keep:  # the entry holds the prepared copy until the launch is queued
        return None, None, None, ptrs, launch, out, w
    drop = lambda _, key=key: _STEM_LAUNCHES.pop(key, None)  # noqa: E731
    entry = (weakref.ref(w, drop), weakref.ref(es, drop), weakref.ref(eb, drop), ptrs,
             launch, out)
    _STEM_LAUNCHES[key] = entry
    return entry


def _launch(x, w, es, eb, padding, relu: bool, scale) -> torch.Tensor:
    """One launch of the kernel on CUDA operands: ``w`` HWIO int8
    (``prepare_weight``'s view, else prepared here), es and eb (N,) f32."""
    device = x.device
    key = (id(w), id(es), id(eb), x.shape, x.dtype, _align(x.data_ptr()), padding,
           bool(relu), scale, device)
    e = _STEM_LAUNCHES.get(key)
    if (e is None or device.index != torch._C._cuda_getDevice() or not x.is_contiguous()
            or e[0]() is not w or e[1]() is not es or e[2]() is not eb
            or e[3] != (w.data_ptr(), es.data_ptr(), eb.data_ptr())):
        e = _entry(key, x, w, es, eb, padding, relu, scale)
    y = torch.empty(e[5], dtype=torch.int8, device=device)
    rc = _lib().tf2_qstem(x.data_ptr(), y.data_ptr(), ctypes.addressof(e[4]),
                          build.raw_stream(device))
    build.check_launch(rc, "qstem")
    LAUNCHES["qstem"] += 1
    return y


def _vector(v, device: torch.device) -> torch.Tensor:
    """es or eb as an (N,) f32 tensor on ``device``: the tensor itself where
    it is one (so the launch cache knows it), else a copy."""
    if (isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.dim() == 1
            and v.device == device):
        return v
    return torch.as_tensor(v, dtype=torch.float32).reshape(-1).to(device)


def qstem(x: torch.Tensor, wmat: torch.Tensor, eff_scale, eff_bias, *, kh: int, kw: int,
          padding, relu: bool, scale: float | None = None) -> torch.Tensor:
    """x (B, H, W, cin) f32 with ``scale`` or int8 without; wmat (Kp, cout)
    from ``fold_weight`` -> (B, OH, OW, cout) int8. On the card the weight
    is prepared on the call (``PREPARED_PER_CALL``); raises on a CUDA shape
    the plan takes no launch for."""
    if x.device.type == "cpu":
        return qstem_plain(x, wmat, eff_scale, eff_bias, kh=kh, kw=kw, padding=padding,
                           relu=relu, scale=scale)
    w_q = _unfold_weight(wmat, kh, kw, x.shape[-1])
    return _launch(x, w_q, eff_scale, eff_bias, _norm_padding(padding), relu, scale)


def _two_pass(x, w_q, es, eb, padding, relu: bool, scale) -> torch.Tensor:
    """The quantize (with ``scale``) and the stride-2 conv kernel on the
    HWIO weight (``prepare_weight``'s view holds the same values), as the
    Engine runs a stem its plan keeps off this kernel; counted in
    ``TWO_PASS``."""
    x_q = dispatch.quantize(x, scale) if scale is not None else x
    y = qconv.fused_qconv2d(x_q, w_q.contiguous(), es, eb, strides=(2, 2), padding=padding,
                            groups=1, relu=relu, wfmt="int8", kshape=tuple(w_q.shape))
    TWO_PASS["qstem"] += 1
    return y


def fused_qstem(x: torch.Tensor, w_q, eff_scale, eff_bias, *, padding, relu: bool,
                scale: float | None = None, plain: bool = False):
    """Quantize (with ``scale``) and the stem conv. x (B, H, W, C) f32 with
    ``scale`` or int8; w_q HWIO int8 (on the card ``prepare_weight``'s view
    is read as it is, any other is prepared on the call). -> NHWC int8 (B,
    OH, OW, cout), or None where ``covers`` refuses the shape; the plain
    version when ``plain``. On the card, a stem ``plan`` has no launch for
    takes the quantize and the stride-2 conv kernel (``TWO_PASS``)."""
    padding = _norm_padding(padding)
    kh, kw, cin, cout = tuple(w_q.shape)
    if not covers((kh, kw, cin, cout), (2, 2), padding, 1, tuple(x.shape)):
        return None
    if not plain and x.device.type == "cuda":
        w_q = torch.as_tensor(w_q).to(x.device)
        es, eb = _vector(eff_scale, x.device), _vector(eff_bias, x.device)
        b, h, wd, _ = x.shape
        sms, max_smem = _card(x.device)
        if plan(b, h, wd, cin, cout, kh, padding, scale is not None, _align(x.data_ptr()), sms,
                min(SMEM_LIMIT, max_smem)) is None:
            return _two_pass(x, w_q, es, eb, padding, relu, scale)
        return _launch(x, w_q, es, eb, padding, relu, scale)
    wmat = fold_weight(w_q).to(x.device)
    es = torch.as_tensor(eff_scale, dtype=torch.float32).reshape(-1).to(x.device)
    eb = torch.as_tensor(eff_bias, dtype=torch.float32).reshape(-1).to(x.device)
    return qstem_plain(x, wmat, es, eb, kh=kh, kw=kw, padding=padding, relu=relu, scale=scale)
