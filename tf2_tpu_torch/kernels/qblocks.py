"""Fused chain of stride-1 residual bottleneck blocks (ResNet's stage
interiors), each block

    h  = relu-requant(x . w1)                  1x1
    g  = relu-requant(conv3x3_SAME(h, w2))     zero pads
    y3 = requant(g . w3)                       1x1, no relu
    r  = x, or requant(x . wd)                 identity or 1x1 downsample
    x  = clip(rint(relu?(y3 * sa/so + r * sb/so)), +-127)

on NHWC int8. ``qblockchain`` launches ``csrc/qblocks.cu`` once per block
on CUDA tensors, each launch as ``plan`` lays it out (whole images or bands
a cluster, CTAs a cluster, MMA width), and takes the plain version
(``qblockchain_plain``, built from the port's exact conv/GEMM pieces) on
CPU tensors. The c3 requant and then the add's rounding are the
reference's double rounding, reproduced exactly by both.

A block's dict: ``w1`` (Cin, Cm), ``w2`` (3, 3, Cm, Cm), ``w3`` (Cm, Cout)
int8; ``es*``/``eb*`` f32 per channel; optional ``wd`` (Cin, Cout) with
``esd``/``ebd``; ``sa_over_so``/``sb_over_so`` (host floats, used as f32);
``relu`` for the add. The kernel reads every weight K-major (w2 as (Cm,
9 * round_up(Cm, 16)) rows in (dy, dx, c) order): ``prepare_w2`` and
``shift_matmul.prepare_weight`` make those copies and return them as views
of the block dict's shapes (the Engine makes them once, at load); a weight
that is not such a view is prepared on each call, counted in
``PREPARED_PER_CALL``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import build, qconv, shift_matmul

SOURCE = "qblocks.cu"
LAUNCHES = {"qblockchain": 0}
# weights the wrapper prepared (K-major) on a call, having been given none
# prepared; 0 on every Engine forward
PREPARED_PER_CALL = {"qblockchain": 0}
# x, xs, w1, l1, es1, eb1, w2, l2, es2, eb2, w3, l3, es3, eb3, wd, ld, esd,
# ebd, y, ys, b, h, w, cin, cm, cout, down, relu, saso, sbso, G, R, WC, C,
# bn, stream
_SIG = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p] * 4
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])

TM = 128                # csrc/qblocks.cu: pixels of an MMA tile
BK = 64                 # reduction indices per K step
STAGES = 4              # ring slots
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on sm_90
SMEM_PER_SM = 233472    # shared memory of an SM; each resident block also takes 1 KB
H100_SMS = 132
PORTABLE_CLUSTER = 8    # CTAs a cluster on any sm_90 card; 16 where the card allows
MAX_BAND = 16           # output rows of a band, at most
# The plan's cost model, per CTA: int8 MACs an SM sustains on these tiles,
# a K step's fixed cost (barrier, waits, copy issue), an output tile's
# epilogue, and an SM's throughput with two CTAs resident against one.
# Fitted on the H100 to the time of every plan candidate of ResNet-50's
# block shapes at batch 64 and 1 (bench/qblocks_ab.py --plans, PERF.md):
# with them the plan picks the fastest candidate of each.
MAC_PER_S = 4.0e12
STEP_S = 200e-9
TILE_S = 1e-6
TWO_CTAS = 1.25


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library(SOURCE)
    lib.tf2_qblock.argtypes, lib.tf2_qblock.restype = _SIG, ctypes.c_int
    lib.tf2_qblock_max_clusters.argtypes = [ctypes.c_int] * 8
    lib.tf2_qblock_max_clusters.restype = ctypes.c_int
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


def _round16(c: int) -> int:
    return -(-c // 16) * 16


# ---- the 3x3's K-major weight ----

def prepare_w2(w2: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cm, Cm) HWIO int8 -> the same values as a view of K-major rows
    (Cm, 9 * round_up(Cm, 16)), K in (dy, dx, c) order, zero past Cm in
    each tap: the layout ``csrc/qblocks.cu`` copies from."""
    cm = w2.shape[3]
    cmp = _round16(cm)
    rows = torch.zeros((cm, 9, cmp), dtype=torch.int8, device=w2.device)
    rows[:, :, :cm] = w2.reshape(9, cm, cm).permute(2, 0, 1)
    return rows.reshape(cm, 9 * cmp).as_strided((3, 3, cm, cm), (3 * cmp, cmp, 1, 9 * cmp))


def w2_ld(w2: torch.Tensor) -> int | None:
    """The row stride of ``w2``'s K-major rows if ``w2`` is a view the
    kernel reads as it is (``prepare_w2``'s layout), else None."""
    if w2.dim() != 4 or w2.dtype != torch.int8:
        return None
    cm = w2.shape[3]
    cmp = _round16(cm)
    s0, s1, s2, ld = w2.stride()
    if (s0, s1) != (3 * cmp, cmp) or (cm > 1 and s2 != 1) or ld % 16 or ld < 9 * cmp \
            or w2.data_ptr() % 16:
        return None
    need = w2.storage_offset() + (cm - 1) * ld + 9 * cmp
    return ld if w2.untyped_storage().nbytes() >= need else None


# ---- the launch plan ----

def pixel_stride(cm: int) -> int:
    """Bytes of a pixel row of sH and sG: round_up(Cm, 16) plus 16 or 32,
    an odd number of 16-byte chunks (conflict-free ldmatrix)."""
    cmp = _round16(cm)
    return cmp + (32 if (cmp >> 4) & 1 else 16)


def smem_bytes(h: int, w: int, cm: int, g: int, r: int, wc: int, bn: int) -> int:
    """Shared memory of one CTA (csrc/qblocks.cu: Layout): the ring of
    STAGES slots (a 128-pixel A tile and a BN-row weight tile of 64 bytes
    each), the output and residual tiles [128][BN + 16], the 3x3's tap
    table and a zero row, sH (G x min(R + 2, H) x min(WC + 2, W) pixels:
    the piece and its halo) and sG (G x R x WC pixels)."""
    ps = pixel_stride(cm)
    steps2 = -(-9 * _round16(cm) // BK)
    return (STAGES * (TM + bn) * BK + 2 * TM * (bn + 16) + _round16(steps2 * 16) + 16
            + g * min(r + 2, h) * min(wc + 2, w) * ps + g * r * wc * ps)


@dataclass(frozen=True)
class Plan:
    """How one block launches: a cluster of ``c`` CTAs owns ``g`` whole
    images (``whole``) or one image's band of ``r`` rows and ``wc`` columns;
    each CTA computes 1/c of every conv's output channels on wgmma tiles
    ``bn`` channels wide. ``est_s``: the cost model's time."""
    g: int
    r: int
    wc: int
    c: int
    bn: int
    whole: bool
    tiles_y: int
    tiles_x: int
    clusters: int
    smem: int
    est_s: float

    @property
    def ctas(self) -> int:
        return self.clusters * self.c

    @property
    def name(self) -> str:
        if self.whole:
            return f"cluster G{self.g} C{self.c} n{self.bn}"
        return f"band {self.r}x{self.wc} C{self.c} n{self.bn}"


def _slices(c: int, cm: int, cout: int) -> bool:
    """Can ``c`` CTAs split the channels? Each slice a multiple of 16 (the
    16-byte chunks a CTA writes into its neighbours' shared memory)."""
    return c == 1 or (cm % (16 * c) == 0 and cout % (16 * c) == 0)


def _cost(b, h, w, cin, cm, cout, down, g, r, wc, c, bn, smem, sms) -> float:
    """The cost model's time of a launch: the waves of CTAs times the time
    of the largest CTA (MACs on its padded tiles, K steps, output tiles)."""
    rows, cols, nimg = min(r, h), min(wc, w), min(g, b)
    m1 = nimg * min(rows + 2, h) * min(cols + 2, w)
    m = nimg * rows * cols
    nt1, nt3 = -(-(-(-cm // c)) // bn), -(-(-(-cout // c)) // bn)
    mt1, mt = -(-m1 // TM), -(-m // TM)
    ks1, ks2, ks3 = -(-cin // BK), -(-9 * _round16(cm) // BK), -(-_round16(cm) // BK)
    steps = mt1 * nt1 * ks1 + mt * nt1 * ks2 + mt * nt3 * (ks3 + (ks1 if down else 0))
    tiles = mt1 * nt1 + mt * nt1 + mt * nt3 * (2 if down else 1)
    t = steps * TM * bn * BK / MAC_PER_S + steps * STEP_S + tiles * TILE_S
    clusters = -(-b // g) * -(-h // r) * -(-w // wc)
    two = SMEM_PER_SM // (smem + 1024) >= 2
    return math.ceil(clusters * c / (sms * (TWO_CTAS if two else 1))) * t


def _candidates(b, h, w, cm, cout, max_cluster):
    """(g, r, wc) pieces and cluster sizes the kernel takes: whole images
    (g of them, up to 256 pixels), bands of up to MAX_BAND full-width rows,
    and, where even one full-width row does not fit, narrower bands."""
    pieces = [(g, h, w) for g in range(1, b + 1) if g * h * w <= 2 * TM]
    pieces += [(1, r, w) for r in range(1, min(h, MAX_BAND) + 1) if (1, r, w) not in pieces]
    if smem_bytes(h, w, cm, 1, 1, w, 32) > SMEM_LIMIT:
        pieces += [(1, 1, wc) for wc in range(1, w)]
    sizes = [c for c in (1, 2, 4, 8, 16) if c <= max_cluster and _slices(c, cm, cout)]
    for g, r, wc in pieces:
        for c in sizes:
            yield g, r, wc, c, 64 if cm // c >= 64 else 32


def make_plan(b: int, h: int, w: int, cm: int, g: int, r: int, wc: int, c: int, bn: int,
              est_s: float = 0.0) -> Plan:
    """The plan of pieces (g, r, wc) on clusters of c CTAs, bn wide."""
    clusters = -(-b // g) * -(-h // r) * -(-w // wc)
    return Plan(g, r, wc, c, bn, r == h and wc == w, -(-h // r), -(-w // wc), clusters,
                smem_bytes(h, w, cm, g, r, wc, bn), est_s)


@functools.lru_cache(maxsize=512)
def plan(b: int, h: int, w: int, cin: int, cm: int, cout: int, down: bool,
         sms: int = H100_SMS, max_cluster: int = PORTABLE_CLUSTER,
         smem_limit: int = SMEM_LIMIT) -> Plan | None:
    """The launch of one block: the candidate of least modelled time whose
    shared memory fits ``smem_limit``; None where none fits."""
    best = None
    for g, r, wc, c, bn in _candidates(b, h, w, cm, cout, max_cluster):
        smem = smem_bytes(h, w, cm, g, r, wc, bn)
        if smem > smem_limit:
            continue
        p = make_plan(b, h, w, cm, g, r, wc, c, bn,
                      _cost(b, h, w, cin, cm, cout, down, g, r, wc, c, bn, smem, sms))
        key = (p.est_s, p.ctas, -g)
        if best is None or key < best[0]:
            best = (key, p)
    return None if best is None else best[1]


def pieces(p: Plan, b: int, h: int, w: int, cm: int, cout: int):
    """The kernel's partition, CTA by CTA (csrc/qblocks.cu: the piece of
    blockIdx.x): (images, output rows, output columns, c1 rows, c1
    columns, c1 and 3x3 output channels, c3 output channels), each a
    range."""
    cms, cos = -(-cm // p.c), -(-cout // p.c)
    for cta in range(p.ctas):
        cl, rank = divmod(cta, p.c)
        bx, by = cl % p.tiles_x, cl // p.tiles_x % p.tiles_y
        img0 = cl // (p.tiles_x * p.tiles_y) * p.g
        r0, q0 = by * p.r, bx * p.wc
        rows, cols = min(p.r, h - r0), min(p.wc, w - q0)
        m_lo, o_lo = min(rank * cms, cm), min(rank * cos, cout)
        yield (range(img0, min(img0 + p.g, b)), range(r0, r0 + rows), range(q0, q0 + cols),
               range(max(r0 - 1, 0), min(r0 + rows + 1, h)),
               range(max(q0 - 1, 0), min(q0 + cols + 1, w)),
               range(m_lo, min(m_lo + cms, cm)), range(o_lo, min(o_lo + cos, cout)))


def covers(shape, blocks, smem_limit: int = SMEM_LIMIT) -> bool:
    """Does the chain kernel take this chain? Every block has a plan whose
    shared memory fits ``smem_limit`` (the card's), identity blocks keep the
    channel count, and each block reads the previous one's output."""
    b, h, w, cin = shape
    for blk in blocks:
        cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
        if blk["w1"].shape[0] != cin or "wd" not in blk and cin != cout:
            return False
        if plan(max(b, 1), h, w, cin, cm, cout, "wd" in blk, smem_limit=smem_limit) is None:
            return False
        cin = cout
    return True


@functools.cache
def _max_cluster(h: int, w: int, cm: int, g: int, r: int, wc: int, c: int, bn: int) -> int:
    return _lib().tf2_qblock_max_clusters(h, w, cm, g, r, wc, c, bn)


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(b: int, h: int, w: int, cin: int, cm: int, cout: int, down: bool,
                device: torch.device) -> Plan:
    """The plan the kernel takes on this card: clusters of 16 CTAs where
    the card holds one of that plan's shape, else at most 8."""
    sms = _sms(device)
    p = plan(b, h, w, cin, cm, cout, down, sms, 16)
    if p.c > PORTABLE_CLUSTER and _max_cluster(h, w, cm, p.g, p.r, p.wc, p.c, p.bn) < 1:
        p = plan(b, h, w, cin, cm, cout, down, sms, PORTABLE_CLUSTER)
    return p


def _check_block(dev, blk, cin: int) -> tuple[int, int]:
    cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
    ops = {}
    for k, n in (("1", cm), ("2", cm), ("3", cout)):
        ops["es" + k] = (blk["es" + k], torch.float32, (n,))
        ops["eb" + k] = (blk["eb" + k], torch.float32, (n,))
    shapes = {"w1": (cin, cm), "w2": (3, 3, cm, cm), "w3": (cm, cout)}
    if "wd" in blk:
        shapes["wd"] = (cin, cout)
        ops["esd"] = (blk["esd"], torch.float32, (cout,))
        ops["ebd"] = (blk["ebd"], torch.float32, (cout,))
    build.check_operands(dev, **ops)
    for k, shape in shapes.items():
        wt = blk[k]
        if wt.device != dev or wt.dtype != torch.int8 or tuple(wt.shape) != shape:
            raise ValueError(f"{k}: {wt.dtype} {tuple(wt.shape)} on {wt.device}, expected "
                             f"torch.int8 {shape} on {dev}")
    return cm, cout


def _rows(w: torch.Tensor, w2: bool = False) -> tuple[torch.Tensor, int]:
    """(a view the kernel reads, its row stride): the weight as given when
    it is prepared, else prepared now (counted)."""
    ld = w2_ld(w) if w2 else shift_matmul.prepared_ld(w)
    if ld is None:
        w = prepare_w2(w) if w2 else shift_matmul.prepare_weight(w)
        ld = w.stride(3) if w2 else w.stride(1)
        PREPARED_PER_CALL["qblockchain"] += 1
    return w, ld


def qblockchain(x_q: torch.Tensor, blocks) -> torch.Tensor:
    """x_q (B, H, W, Cin) int8 -> (B, H, W, Cout) int8 through the chain.
    One kernel launch per block as ``launch_plan`` lays it out, output
    ping-ponging between two buffers. Raises on a CUDA chain the kernel
    does not take."""
    if x_q.device.type == "cpu":
        return qblockchain_plain(x_q, blocks)
    b, h, w, cin = x_q.shape
    dev = x_q.device
    build.check_operands(dev, x_q=(x_q, torch.int8, (b, h, w, cin)))
    if not covers(x_q.shape, blocks):
        raise ValueError(f"qblockchain: the chain kernel does not take this chain on "
                         f"{tuple(x_q.shape)}")
    stream = build.raw_stream(dev)
    # pixels of 16-byte multiples, zero past the channels
    xs = _round16(cin)
    if xs != cin or x_q.data_ptr() % 16:
        x_q = F.pad(x_q, (0, xs - cin))
    couts = [_round16(blk["w3"].shape[1]) for blk in blocks]
    alloc = torch.zeros if any(c != blk["w3"].shape[1] for c, blk in zip(couts, blocks)) \
        else torch.empty
    bufs = [alloc(b * h * w * max(couts), dtype=torch.int8, device=dev)
            for _ in range(min(2, len(blocks)))]
    for i, blk in enumerate(blocks):
        cm, cout = _check_block(dev, blk, cin)
        ys = couts[i]
        y = bufs[i % 2][:b * h * w * ys].view(b, h, w, ys)
        down = "wd" in blk
        w1, l1 = _rows(blk["w1"])
        w2, l2 = _rows(blk["w2"], w2=True)
        w3, l3 = _rows(blk["w3"])
        wd, ld = _rows(blk["wd"]) if down else (None, 16)
        p = launch_plan(b, h, w, cin, cm, cout, down, dev)
        rc = _lib().tf2_qblock(
            x_q.data_ptr(), xs, w1.data_ptr(), l1, blk["es1"].data_ptr(), blk["eb1"].data_ptr(),
            w2.data_ptr(), l2, blk["es2"].data_ptr(), blk["eb2"].data_ptr(),
            w3.data_ptr(), l3, blk["es3"].data_ptr(), blk["eb3"].data_ptr(),
            wd.data_ptr() if down else None, ld, blk["esd"].data_ptr() if down else None,
            blk["ebd"].data_ptr() if down else None, y.data_ptr(), ys,
            b, h, w, cin, cm, cout, int(down), int(blk["relu"]),
            build.f32(blk["sa_over_so"]), build.f32(blk["sb_over_so"]),
            p.g, p.r, p.wc, p.c, p.bn, stream)
        build.check_launch(rc, "qblockchain")
        x_q, cin, xs = y, cout, ys
    LAUNCHES["qblockchain"] += 1
    return x_q if xs == cin else x_q[..., :cin].contiguous()


def fused_qblockchain(x_q: torch.Tensor, blocks, plain: bool = False) -> torch.Tensor:
    """Dispatch entry: the chain kernel, or its plain version when
    ``plain``."""
    return qblockchain_plain(x_q, blocks) if plain else qblockchain(x_q, blocks)
