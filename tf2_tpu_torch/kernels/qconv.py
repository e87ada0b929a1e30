"""Fused shift-quantized k x k conv: NHWC int8 x HWIO weights -> requant ->
NHWC int8.

``qconv_s1``, ``qconv_s2`` and ``qconv_s2x1`` launch the stride (1, 1),
(2, 2) and (2, 1) entry points of ``csrc/qconv.cu`` on CUDA tensors, an
implicit GEMM over the unpadded image with TF-SAME pads applied inside the
kernel, each launch as ``plan`` lays it out (kernel variant, tile, copy
widths and a gather table, cached per shape with the table on the card);
on CPU tensors they take the plain version (``qconv_plain``:
explicit ``F.pad``, exact float64 ``F.conv2d``, the same f32 epilogue).
Stride (2, 1) is the W-pair-packed stem (``wpack2``, dispatch.qconv2d).
``fused_qconv2d`` runs a conv by its shape: ungrouped 1x1 stride-1 convs on
the GEMM kernels of ``shift_matmul``, the others on these kernels, or its
plain version (with ``plain``, or on the CPU); it raises on a card tensor
the kernels do not take (``covers``: grouped, or another stride). The
executor (``dispatch.qconv2d``) runs the kernel the Engine's plan
(``dispatch.kernel_of``) names, and a conv no kernel takes on
``fused_qconv2d``'s plain version, as the reference sends it to XLA.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..transform import potq
from . import build, shift_matmul

SOURCE = "qconv.cu"
LAUNCHES = {"qconv_s1": 0, "qconv_s2": 0, "qconv_s2x1": 0}
KERNELS = {(1, 1): "qconv_s1", (2, 2): "qconv_s2", (2, 1): "qconv_s2x1"}
# x, w, es, eb, y; b, h, w, c, oh, ow, kh, kw, pad_top, pad_left, n, pot4,
# relu; stream; then the plan: table, variant, avec, bvec, tile_h, tile_w,
# the split-K workspace and counters, splits
_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p] * 2 + \
    [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library(SOURCE)
    for kernel in KERNELS.values():
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
    (2, 2) or (2, 1). (The Engine's predecode and ``dispatch.kernel_of`` ask
    it.)"""
    return groups == 1 and tuple(strides) in KERNELS


# ---- the launch plan: variant, copy widths and gather table per conv ----
#
# csrc/qconv.cu has two kernel families. The pipelined one streams 64-deep K
# steps of the packed weights through a ring of shared-memory stages with
# cp.async, and takes its A operand either from a ring of im2col tiles
# gathered from the image in chunks of `avec` bytes (16, 8 or 4: the
# largest that divides C, K/2 for pot4, and the image's address; each chunk
# inside one tap), variants 0-3, or, for k x k convs with 16-byte chunks,
# straight from the input patch of a tile_h x tile_w output tile copied
# into shared memory once (variants 5-8: stride 1, where a tile fills at
# least 3/4 of its BM rows). A block has 256 threads (two warpgroups), 512
# at BM 256. The staged kernel (variant
# STAGED) copies the patch of the layers whose C no 4-byte copy divides (the
# 3- and 6-channel stems) and builds the im2col tile from it. All of them
# walk K through a table built here, so the kernels divide by nothing in
# their K loops.

# (BM, BN) of variants 0-3, and with the patch 5-8
PIPE_TILES = ((256, 128), (128, 128), (128, 64), (64, 64))
STAGED = 4
PATCH = 5             # variant of PIPE_TILES[0] with the patch; 6-8 the others
BK = 64               # reduction indices per pipelined K step
STAGED_BK = 32        # per staged K step: K is padded to a multiple of 32
STAGED_BM, STAGED_BN = 128, 64
STAGES = 3            # cp.async ring depth of the pipelined kernel
THREADS = 256
SMEM_LIMIT = 232448   # dynamic shared memory a block may have on sm_90
H100_SMS = 132
_INVALID_TAP = 0x7FFF << 16  # im2col table: dy past any image, so zero-filled


def _roundup(v: int, m: int) -> int:
    return -(-v // m) * m


def _align(ptr: int) -> int:
    """The largest of 16, 8, 4, 2, 1 that divides ``ptr``."""
    return min(16, ptr & -ptr) if ptr else 16


@dataclass(frozen=True)
class Plan:
    """How one conv launches (csrc/qconv.cu). ``table``, int32: for the
    im2col variants (steps, BK // avec, 2), entry (s, q) the input offset
    (dy * W + dx) * C + c of the chunk's first index and (dy << 16) | dx
    (dy = 0x7FFF past the end of K); for the patch variants (steps, 4), the
    patch offset (dy * PW + dx) * CPS + c of each 16-column chunk, or -1
    past K; for the staged variant (Kpad,), entry k the pair (dy << 16) |
    (dx * C + c), or -1 past K."""
    variant: int
    bm: int
    bn: int
    avec: int       # image copy width in bytes (pipelined; 0 for staged)
    bvec: int       # weight copy width: 16, 8, 4, or 0 for 4-byte copies of unaligned rows
    tile_h: int     # output tile in pixels (patch and staged; 0 for im2col)
    tile_w: int
    grid: tuple[int, int]
    smem: int       # dynamic shared memory a block takes, in bytes
    table: np.ndarray
    splits: int = 1  # split-K: blocks a tile, each over a run of the K steps

    @property
    def name(self) -> str:
        split = f" split{self.splits}" if self.splits > 1 else ""
        if self.variant == STAGED:
            return f"staged {self.tile_h}x{self.tile_w}px b{self.bvec}"
        if self.variant >= PATCH:
            return f"patch {self.bm}x{self.bn} {self.tile_h}x{self.tile_w}px b{self.bvec}{split}"
        return f"pipe {self.bm}x{self.bn} a{self.avec} b{self.bvec}{split}"


def _k_of(k: int, c: int, kw: int) -> tuple[int, int, int]:
    """Reduction index k of HWIO order -> (dy, dx, c)."""
    tap, ci = divmod(k, c)
    return tap // kw, tap % kw, ci


def _bvec(n: int, w_align: int) -> int:
    return next((v for v in (16, 8, 4) if n % v == 0 and w_align % v == 0), 0)


def _step_columns(k: int, pot4: bool, step: int, j: int):
    """The reduction index of column j (0-63) of pipelined K step ``step``,
    or None past K: pot4 in the split-half order (qgemm.cuh)."""
    if pot4:
        half = k // 2
        r = 32 * step + j % 32
        return (r if j < 32 else half + r) if r < half else None
    kk = BK * step + j
    return kk if kk < k else None


def _steps(k: int, pot4: bool) -> int:
    return -(-(k // 2) // 32) if pot4 else -(-k // BK)


def _pipe_table(w, c, kw, k, pot4, avec) -> np.ndarray:
    steps = _steps(k, pot4)
    table = np.empty((steps, BK // avec, 2), np.int32)
    for s in range(steps):
        for q in range(BK // avec):
            kk = _step_columns(k, pot4, s, q * avec)
            if kk is None:
                table[s, q] = (0, _INVALID_TAP)
            else:
                dy, dx, ci = _k_of(kk, c, kw)
                table[s, q] = ((dy * w + dx) * c + ci, (dy << 16) | dx)
    return table


def patch_geometry(c: int, kh: int, kw: int, sh: int, sw: int, tile_h: int,
                   tile_w: int) -> tuple[int, int, int]:
    """(rows, pixels a row, pixel stride in bytes) of a patch variant's
    input patch (csrc/qconv_pipe.cuh: Patch): the stride is C plus 16 or 32
    bytes, an odd number of 16-byte chunks."""
    return ((tile_h - 1) * sh + kh, (tile_w - 1) * sw + kw,
            c + (32 if (c >> 4) & 1 else 16))


def _patch_table(c, kw, k, pot4, pw, cps) -> np.ndarray:
    steps = _steps(k, pot4)
    table = np.full((steps, 4), -1, np.int32)
    for s in range(steps):
        for q in range(4):
            kk = _step_columns(k, pot4, s, 16 * q)
            if kk is not None:
                dy, dx, ci = _k_of(kk, c, kw)
                table[s, q] = (dy * pw + dx) * cps + ci
    return table


def staged_smem(k: int, n_rows_raw: int, c: int, kh: int, kw: int, sh: int, sw: int,
                tile_h: int, tile_w: int) -> int:
    """Shared memory of the staged kernel (the layout of csrc/qconv_pipe.cuh's
    conv_staged): the A double buffer (or the output tile), B^T, the raw
    weight rows, the input patch, the table, the patch row addresses."""
    kpad = _roundup(k, STAGED_BK)
    ph, pw = (tile_h - 1) * sh + kh, (tile_w - 1) * sw + kw
    return (max(2 * STAGED_BM * STAGED_BK, STAGED_BM * (STAGED_BN + 16))
            + STAGED_BN * (kpad + 16) + _roundup(n_rows_raw, 4) * (STAGED_BN + 16)
            + ph * _roundup(pw * c + 32, 16) + kpad * 4 + _roundup(ph * 4, 16))


def pipe_smem(bm: int, bn: int, pot4: bool, a_bytes: int, table_bytes: int) -> int:
    """Shared memory of the pipelined kernel (csrc/qconv_pipe.cuh:
    pipe_smem): the A region (the im2col stages, or the patch and 16 zero
    bytes; the output tile reuses it), STAGES raw weight stages, two
    decoded B^T tiles and the table, the regions 1024-byte aligned."""
    return (_roundup(max(a_bytes, bm * (bn + 16)), 1024)
            + _roundup(STAGES * (32 if pot4 else BK) * (bn + 16), 1024) + 2 * bn * BK
            + table_bytes)


def _tile(bm, oh, ow, kh, kw, sh, sw, fits) -> tuple[int, int] | None:
    """(tile_h, tile_w) of at most ``bm`` output pixels for which
    ``fits(th, tw)``: the fewest tiles over the image (each costs bm rows of
    MMA), then the smallest input patch, then the widest."""
    best = None
    for tw in sorted({ow} | {4, 8, 16, 32, 64, 128}):
        if tw > bm or (tw > ow and tw != 4):
            continue
        th = min(bm // tw, oh)
        if not fits(th, tw):
            continue
        tiles = -(-oh // th) * -(-ow // tw)
        key = (tiles, ((th - 1) * sh + kh) * ((tw - 1) * sw + kw), -tw)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return None if best is None else best[1]


def _pick_tile(m_blocks, n: int, sms: int) -> int:
    """Index into PIPE_TILES: where N fills whole 128-column tiles (or as
    well as 64-column ones), 256 x 128 while the grid has a block for 3/4 of
    the SMs, else 128 x 128 while it has one for every other SM; else
    128 x 64 while it has one for every other SM; else 64 x 64.
    ``m_blocks(bm)`` is the number of M tiles at tile height bm. (Measured
    on the H100: each pot4 K step decodes BN x 64 weights a block, so the
    largest tile that keeps the SMs busy wins; PERF.md. A 256 x 64 tile lost
    to 128 x 64 at ResNet-50's stage 1.)"""
    if n > 64 and _roundup(n, 128) == _roundup(n, 64):
        if 4 * m_blocks(256) * -(-n // 128) >= 3 * sms:
            return 0
        if 2 * m_blocks(128) * -(-n // 128) >= sms:
            return 1
    if 2 * m_blocks(128) * -(-n // 64) >= sms:
        return 2
    return 3


def _splits(grid: tuple[int, int], bm: int, steps: int, sms: int) -> int:
    """Split-K: where a grid of 128- or 64-row tiles has fewer blocks than
    SMs, each tile's K steps are cut into runs of at least 8 so that the
    grid has about 1.5 blocks for every SM; each split stores its int32
    sums in a workspace and the last one adds them and runs the epilogue.
    (Measured on the H100 at ResNet-50's stage 4 at batch 64, 100 blocks of
    72 steps: 2 splits 68 us, none 85, 3 or 4 splits 76-80; PERF.md.)"""
    blocks = grid[0] * grid[1]
    if bm > 128 or blocks >= sms or steps < 16:
        return 1
    splits = min(max(2, round(1.5 * sms / blocks)), steps // 8)
    per = -(-steps // splits)
    return -(-steps // per)  # no empty run


def plan(b: int, h: int, w: int, c: int, oh: int, ow: int, kh: int, kw: int, sh: int,
         sw: int, n: int, pot4: bool, x_align: int = 16, w_align: int = 16,
         sms: int = H100_SMS) -> Plan:
    """The launch of one conv: deterministic in its shape, the operands'
    address alignment and the card's SM count."""
    k = kh * kw * c
    avec = next((v for v in (16, 8, 4) if c % v == 0 and x_align % v == 0
                 and (not pot4 or (k // 2) % v == 0)), 0)
    bvec = _bvec(n, w_align)
    if not avec:
        if kw * c >= 1 << 16:
            raise ValueError(f"conv kernels: KW * C = {kw * c} too wide for the staged gather")
        n_raw = k // 2 if pot4 else k
        tile = _tile(STAGED_BM, oh, ow, kh, kw, sh, sw, lambda th, tw: staged_smem(
            k, n_raw, c, kh, kw, sh, sw, th, tw) <= SMEM_LIMIT)
        if tile is None:
            raise ValueError(f"conv kernels: a staged tile of C={c}, K={k} does not fit "
                             f"in {SMEM_LIMIT} bytes of shared memory")
        th, tw = tile
        kpad = _roundup(k, STAGED_BK)
        table = np.full(kpad, -1, np.int32)
        for kk in range(k):
            dy, dx, ci = _k_of(kk, c, kw)
            table[kk] = (dy << 16) | (dx * c + ci)
        grid = (b * -(-oh // th) * -(-ow // tw), -(-n // STAGED_BN))
        return Plan(STAGED, STAGED_BM, STAGED_BN, 0, bvec, th, tw, grid,
                    staged_smem(k, n_raw, c, kh, kw, sh, sw, th, tw), table)
    steps = _steps(k, pot4)
    if avec == 16 and kh * kw > 1 and (sh, sw) == (1, 1):
        def patch_bytes(th, tw):
            ph, pw, cps = patch_geometry(c, kh, kw, sh, sw, th, tw)
            return ph * pw * cps + 16

        tiles = {bm: _tile(bm, oh, ow, kh, kw, sh, sw, lambda th, tw, bm=bm: pipe_smem(
            bm, 64, pot4, patch_bytes(th, tw), steps * 16) <= SMEM_LIMIT) for bm in (256, 128, 64)}
        if all(tiles.values()):
            def m_blocks(bm):
                th, tw = tiles[bm]
                return b * -(-oh // th) * -(-ow // tw)

            t = _pick_tile(m_blocks, n, sms)
            bm, bn = PIPE_TILES[t]
            th, tw = tiles[bm]
            smem = pipe_smem(bm, bn, pot4, patch_bytes(th, tw), steps * 16)
            if smem <= SMEM_LIMIT and 4 * th * tw >= 3 * bm:
                _, pw, cps = patch_geometry(c, kh, kw, sh, sw, th, tw)
                grid = (m_blocks(bm), -(-n // bn))
                return Plan(PATCH + t, bm, bn, avec, bvec, th, tw, grid, smem,
                            _patch_table(c, kw, k, pot4, pw, cps),
                            _splits(grid, bm, steps, sms))
    m = b * oh * ow
    t = _pick_tile(lambda bm: -(-m // bm), n, sms)
    bm, bn = PIPE_TILES[t]
    table = _pipe_table(w, c, kw, k, pot4, avec)
    grid = (-(-m // bm), -(-n // bn))
    return Plan(t, bm, bn, avec, bvec, 0, 0, grid,
                pipe_smem(bm, bn, pot4, STAGES * bm * BK, table.nbytes), table,
                _splits(grid, bm, steps, sms))


@functools.lru_cache(maxsize=512)
def _device_plan(key: tuple, device: torch.device):
    """(plan, its table on the device, its split-K workspace (a tile of
    int32 sums for each split) and counters (int32 zeros the kernel leaves
    zero): one set a plan, so calls of one plan share them and run on one
    stream)."""
    p = plan(*key)
    tiles = p.grid[0] * p.grid[1] if p.splits > 1 else 1
    return (p, torch.as_tensor(p.table).to(device),
            torch.empty(p.splits * tiles * p.bm * p.bn, dtype=torch.int32, device=device),
            torch.zeros(tiles, dtype=torch.int32, device=device))


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_key(x_q, wparam, strides, kshape, oh: int, ow: int, wfmt: str) -> tuple:
    b, h, w, c = x_q.shape
    kh, kw, _, n = kshape
    return (b, h, w, c, oh, ow, kh, kw, *strides, n, wfmt == "pot4",
            _align(x_q.data_ptr()), _align(wparam.data_ptr()), _sms(x_q.device))


def launch_plan(x_q, wparam, *, strides, kshape, pads, wfmt: str) -> Plan:
    """The plan the conv kernel takes for these CUDA operands."""
    (ph0, ph1), (pw0, pw1) = pads
    _, h, w, _ = x_q.shape
    oh = out_size(h, kshape[0], strides[0], ph0, ph1)
    ow = out_size(w, kshape[1], strides[1], pw0, pw1)
    return _device_plan(_plan_key(x_q, wparam, tuple(strides), kshape, oh, ow, wfmt),
                        x_q.device)[0]


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
    kernel = KERNELS[(sh, sw)]
    p, table, ws, counters = _device_plan(
        _plan_key(x_q, wparam, strides, kshape, oh, ow, wfmt), x_q.device)
    y = torch.empty((b, oh, ow, cout), dtype=torch.int8, device=x_q.device)
    rc = getattr(_lib(), f"tf2_{kernel}")(
        x_q.data_ptr(), wparam.data_ptr(), eff_scale.data_ptr(),
        eff_bias.data_ptr(), y.data_ptr(), b, h, w, cin, oh, ow, kh, kw, ph0, pw0,
        cout, int(wfmt == "pot4"), int(relu),
        build.raw_stream(x_q.device), table.data_ptr(), p.variant,
        p.avec, p.bvec, p.tile_h, p.tile_w, ws.data_ptr(), counters.data_ptr(), p.splits)
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
