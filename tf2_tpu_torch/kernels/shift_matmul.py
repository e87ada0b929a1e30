"""Fused shift-quantized matmul: x (M, K) int8 . W (K, N) -> requant -> int8.

``qmatmul_pot4`` takes W as split-half packed 4-bit PoT codes (K/2, N) and
decodes them on chip; ``qmatmul_int8`` takes int8 W (K, N) and, optionally,
a residual (an int8 (M, N) tensor and its f32 scale) added in the epilogue.
Both launch the CUDA kernels of ``csrc/shift_matmul.cu`` on CUDA tensors
and take their plain versions (``*_plain``) on CPU tensors. The plain
versions decode the codes, accumulate exactly in float64 and apply the same
f32 epilogue op for op; torch's int8 matmul on the CPU returns int8 and
wraps, so it is not used.

Both kernels read W K-major: the int8 one as W^T rows of round_up(K, 16)
bytes, the pot4 one as rows of round_up(K/2, 16) packed bytes.
``prepare_weight`` makes that copy of either (the Engine makes it once, at
load) and returns it as a view of W's own shape, so W keeps its layout at
every signature and the plain versions read the view as it is. A W that is
not such a view is prepared by the wrapper on each call, counted in
``PREPARED_PER_CALL``. ``plan`` and ``plan_pot4`` lay out each launch
(tiles, copy widths, split-K; the pot4 kernel's slab and grid), cached per
shape. The pot4 wrapper also checks its weight's operands and builds its
launch's arguments once for each weight, X shape and alignment and relu
(``_POT4_LAUNCHES``), so that a call costs the host little more than the
launch.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..transform import potq
from . import build

SOURCE = "shift_matmul.cu"
LAUNCHES = {"qmatmul_pot4": 0, "qmatmul_int8": 0}
# weights the wrappers prepared (K-major) on a call, having been given none
# prepared; 0 on every Engine forward
PREPARED_PER_CALL = {"qmatmul_pot4": 0, "qmatmul_int8": 0}
# x, y, launch (a Pot4Launch), stream
_SIG_POT4 = [ctypes.c_void_p] * 4
# x, wt, ldw, es, eb, r, y, m, n, k, relu, radd, tile, avec, ovec, ws,
# counters, splits, stream
_SIG_INT8 = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library(SOURCE)
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


def _roundup(v: int, m: int) -> int:
    return -(-v // m) * m


def _align(ptr: int) -> int:
    """The largest of 16, 8, 4, 2, 1 that divides ``ptr``."""
    return min(16, ptr & -ptr) if ptr else 16


# ---- the GEMMs' K-major weights ----

def prepare_weight(w: torch.Tensor) -> torch.Tensor:
    """(R, N) -> the same values as an (R, N) view of K-major rows
    (N, round_up(R, 16)), zero past R: the layout the kernels copy from.
    For the int8 GEMM R is K (``csrc/qmm_int8.cuh``); for the pot4 GEMM W
    is the packed codes and R is K/2 (``csrc/qmm_pot4.cuh``)."""
    k, n = w.shape
    rows = torch.zeros((n, _roundup(k, 16)), dtype=w.dtype, device=w.device)
    rows[:, :k] = w.t()
    return rows[:, :k].t()


def prepared_ld(w: torch.Tensor) -> int | None:
    """The row stride of ``w``'s K-major rows if ``w`` is an int8 or uint8
    (R, N) view that the kernels read as it is (``prepare_weight``'s
    layout: a stride of 1 along R, rows a multiple of 16 bytes apart, at
    least round_up(R, 16) long in memory, 16-byte aligned), else None."""
    if w.dim() != 2 or w.dtype not in (torch.int8, torch.uint8):
        return None
    k, n = w.shape
    ld = w.stride(1)
    if (k > 1 and w.stride(0) != 1) or ld % 16 or ld < _roundup(k, 16) or w.data_ptr() % 16:
        return None
    need = w.storage_offset() + (n - 1) * ld + _roundup(k, 16)
    return ld if w.untyped_storage().nbytes() >= need else None


# ---- the int8 GEMM's launch plan ----
#
# csrc/qmm_int8.cuh: one block of two warpgroups a BM x BN output tile, a
# cp.async ring of 64-deep K steps (A [BM][64] and W^T [BN][64] a slot),
# int8 wgmma; split-K over workspace slices where the grid is under one
# wave.

TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
BK = 64
MAX_STAGES = 6
ROOM = 232448 // 2 - 1024  # shared memory of one of two blocks an SM
H100_SMS = 132


@dataclass(frozen=True)
class Plan:
    """How one int8 GEMM launches. ``avec``: X's copy width (16, 8 or 4),
    or 0 where neither K nor X's address takes 4 (the wrapper then pads X
    to round_up(K, 16) columns and copies 16); ``ovec``: the output's and
    the residual's copy width (16, 8, 4, 2 or 1); ``splits``: blocks a
    tile along K, each over ``per`` steps."""
    tile: int
    bm: int
    bn: int
    avec: int
    ovec: int
    splits: int
    steps: int
    grid: tuple[int, int, int]
    smem: int
    ws_ints: int       # split-K workspace, int32 elements
    counters: int      # split-K counters, one a tile

    @property
    def per(self) -> int:
        return -(-self.steps // self.splits)

    @property
    def name(self) -> str:
        split = f" split{self.splits}" if self.splits > 1 else ""
        return f"{self.bm}x{self.bn} a{self.avec or 'pad'} o{self.ovec}{split}"


def stages(bm: int, bn: int) -> int:
    """Ring slots of a tile (csrc/qmm_int8.cuh: stages): as many as fit two
    blocks an SM, up to MAX_STAGES."""
    return min(MAX_STAGES, ROOM // ((bm + bn) * BK))


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of a block (csrc/qmm_int8.cuh: smem_bytes):
    the ring, which the epilogue's output and residual tiles reuse."""
    return max(stages(bm, bn) * (bm + bn) * BK, 2 * bm * (bn + 16))


def _pick_tile(m: int, n: int, sms: int) -> int:
    """Index into TILES. M > 64: 128 x 128 and then 128 x 64 while the grid
    has a block for every other SM (two blocks take an SM), else 64 x 64
    (with split-K). M <= 64 (the fc, one image's tokens): 64 x 64 while its
    grid is under a wave (then split along K), else 64 x 128. (Measured on
    the H100, bench/ring_variants.py: 256 x 128 tiles, one block an SM, lost
    to 128 x 128 at every large ViT-B/16 shape.)"""
    mb = lambda bm: -(-m // bm)  # noqa: E731
    nb = lambda bn: -(-n // bn)  # noqa: E731
    if m > 64:
        if n > 64 and 2 * mb(128) * nb(128) >= sms:
            return 0
        if 2 * mb(128) * nb(64) >= sms:
            return 1
        return 3
    return 3 if nb(64) < sms else 2


def _splits(blocks: int, steps: int, sms: int) -> int:
    """Split-K where the grid has fewer blocks than SMs and K has 8 steps
    or more: about 1.5 blocks an SM, runs of at least 4 steps, no empty
    run."""
    if blocks >= sms or steps < 8:
        return 1
    splits = min(max(2, round(1.5 * sms / blocks)), steps // 4)
    per = -(-steps // splits)
    return -(-steps // per)


def plan(m: int, n: int, k: int, x_align: int = 16, o_align: int = 16,
         sms: int = H100_SMS) -> Plan:
    """The launch of one int8 GEMM: deterministic in its shape, X's
    address alignment, the output's (and residual's) address alignment and
    the card's SM count."""
    avec = next((v for v in (16, 8, 4) if k % v == 0 and x_align % v == 0), 0)
    ovec = next(v for v in (16, 8, 4, 2, 1) if n % v == 0 and o_align % v == 0)
    tile = _pick_tile(m, n, sms)
    bm, bn = TILES[tile]
    steps = -(-_roundup(k, 16) // BK) if not avec else -(-k // BK)
    blocks = -(-m // bm) * -(-n // bn)
    splits = _splits(blocks, steps, sms)
    tiles = blocks if splits > 1 else 0
    return Plan(tile, bm, bn, avec, ovec, splits, steps,
                (-(-m // bm), -(-n // bn), splits), smem_bytes(bm, bn),
                splits * tiles * bm * bn, tiles)


@functools.lru_cache(maxsize=512)
def _device_plan(key: tuple, device: torch.device):
    """(plan, its split-K workspace and counters (int32 zeros the kernel
    leaves zero)): one set a plan, so calls of one plan share them and run
    on one stream."""
    p = plan(*key)
    return (p, torch.empty(max(p.ws_ints, 1), dtype=torch.int32, device=device),
            torch.zeros(max(p.counters, 1), dtype=torch.int32, device=device))


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_key(x_q, y, residual) -> tuple:
    m, k = x_q.shape
    o_align = _align(y.data_ptr())
    if residual is not None:
        o_align = min(o_align, _align(residual[0].data_ptr()))
    return (m, y.shape[1], k, _align(x_q.data_ptr()), o_align, _sms(x_q.device))


def launch_plan(x_q, n: int, residual=None) -> Plan:
    """The plan the int8 kernel takes for these CUDA operands (an output
    from ``torch.empty``, as the wrapper's, is 16-byte aligned)."""
    o_align = 16 if residual is None else _align(residual[0].data_ptr())
    m, k = x_q.shape
    return _device_plan((m, n, k, _align(x_q.data_ptr()), o_align, _sms(x_q.device)),
                        x_q.device)[0]


# ---- the pot4 GEMM's launch plan ----
#
# csrc/qmm_pot4.cuh: persistent blocks of one or two warpgroups (BM 64 or
# 128 rows), each holding one N-tile's decoded codes (BN wide, over its K
# split's steps) resident in shared memory while it walks M-tiles, A
# through a 4-slot cp.async ring; split-K where the slab overflows a block's
# shared memory or the grid is under one wave.

POT4_BN = (16, 32, 64, 128)
POT4_STAGES = 4
SMEM_BLOCK = 232448 - 1024  # dynamic shared memory of a block alone on an SM
SMEM_SM = 233472            # shared memory of an SM; a block also takes 1 KB


def pot4_smem(bm: int, bn: int, per: int) -> int:
    """Dynamic shared memory of a pot4 block (csrc/qmm_pot4.cuh:
    smem_bytes): the slab [per][BN][64], the A ring [4][BM][64], the output
    tile [BM][BN + 16], es and eb."""
    return per * bn * BK + POT4_STAGES * bm * BK + bm * (bn + 16) + 8 * bn


@dataclass(frozen=True)
class Pot4Plan:
    """How one pot4 GEMM launches. ``avec``: X's copy width (16, 8 or 4),
    or 0 where neither K nor X's address takes 4 (the wrapper then pads X
    to round_up(K, 16) columns and copies 16); ``ovec``: the output's copy
    width; ``splits`` K splits of ``per`` steps each (``split_for``: "slab"
    where K * BN overflows one block's shared memory, "wave" where the grid
    would be under one wave, else ""); ``grid`` persistent blocks, at most
    ``blocks_per_sm`` an SM, over the items (N-tile, split, M-tile)."""
    bm: int
    bn: int
    avec: int
    ovec: int
    splits: int
    per: int
    steps: int
    mtiles: int
    ntiles: int
    grid: int
    smem: int
    blocks_per_sm: int
    split_for: str
    ws_ints: int       # split-K workspace, int32 elements
    counters: int      # split-K counters, one an output tile

    @property
    def items(self) -> int:
        return self.ntiles * self.splits * self.mtiles

    @property
    def name(self) -> str:
        split = f" split{self.splits}({self.split_for})" if self.splits > 1 else ""
        return (f"{self.bm}x{self.bn} a{self.avec or 'pad'} o{self.ovec} k{self.per}{split}"
                f" g{self.grid}")


def _pot4_tile(m: int, n: int, sms: int) -> tuple[int, int]:
    """(BM, BN), fitted to the shape (bench/pot4_plans.py: every zoo shape's
    candidates, PERF.md §6). BN: the narrowest of 16, 32, 64 holding N;
    above 64, 128 where 128 x 128 tiles give the card 2.5 waves and pad N no
    more than 64 would, else 64. Then, while the tiles are under a wave,
    BN halves down to 32 and then BM drops to 64 (either beats splitting
    K)."""
    if n <= 64:
        bn = next(b for b in POT4_BN if n <= b)
    else:
        wide = -(-m // 128) * -(-n // 128) >= 2.5 * sms
        bn = 128 if wide and _roundup(n, 128) <= _roundup(n, 64) else 64
    bm = 128
    while -(-m // bm) * -(-n // bn) < sms:
        if bn > 32:
            bn //= 2
        elif bm == 128:
            bm = 64
        else:
            break
    return bm, bn


def _pot4_blocks_per_sm(bm: int, bn: int) -> int:
    """The blocks an SM the kernel's registers allow (csrc/qmm_pot4.cuh:
    its __launch_bounds__): 768 threads at BN up to 64, 512 at BN 128."""
    return (2 if bn == 128 else 3) * (128 // bm)


def plan_pot4(m: int, n: int, k: int, x_align: int = 16, o_align: int = 16,
              sms: int = H100_SMS, bm: int | None = None, bn: int | None = None) -> Pot4Plan:
    """The launch of one pot4 GEMM: deterministic in its shape, X's and the
    output's address alignment and the card's SM count (``bm``, ``bn``:
    a tile other than the plan's own, for a sweep). The tile: ``_pot4_tile``;
    K splits where the slab would overflow a block (each split then holds
    its K range) and where the tiles are still under a wave and K has 4
    steps or more (about 1.5 blocks an SM); as many blocks an SM as the
    registers and shared memory allow."""
    avec = next((v for v in (16, 8, 4) if k % v == 0 and x_align % v == 0), 0)
    ovec = next(v for v in (16, 8, 4, 2, 1) if n % v == 0 and o_align % v == 0)
    own_bm, own_bn = _pot4_tile(m, n, sms)
    bm, bn = bm or own_bm, bn or own_bn
    ntiles = -(-n // bn)
    mtiles = -(-m // bm)
    tiles = mtiles * ntiles
    steps = -(-k // BK)
    max_per = (SMEM_BLOCK - pot4_smem(bm, bn, 0)) // (bn * BK)
    fit = -(-steps // max_per)
    wave = 1
    if tiles * fit < sms and steps >= 4:
        wave = min(max(2, round(1.5 * sms / tiles)), steps)
    splits = max(fit, wave)
    per = -(-steps // splits)
    splits = -(-steps // per)
    split_for = "wave" if wave > fit else "slab" if fit > 1 else ""
    smem = pot4_smem(bm, bn, per)
    blocks_per_sm = max(1, min(_pot4_blocks_per_sm(bm, bn), SMEM_SM // (smem + 1024 + 16)))
    items = ntiles * splits * mtiles
    grid = min(items, sms * blocks_per_sm)
    split_tiles = tiles if splits > 1 else 0
    return Pot4Plan(bm, bn, avec, ovec, splits, per, steps, mtiles, ntiles, grid, smem,
                    blocks_per_sm, split_for, splits * split_tiles * bm * bn, split_tiles)


@functools.lru_cache(maxsize=512)
def _device_plan_pot4(key: tuple, device: torch.device):
    """(plan, its split-K workspace and counters), as ``_device_plan``."""
    p = plan_pot4(*key)
    return (p, torch.empty(max(p.ws_ints, 1), dtype=torch.int32, device=device),
            torch.zeros(max(p.counters, 1), dtype=torch.int32, device=device))


def launch_plan_pot4(x_q, n: int) -> Pot4Plan:
    """The plan the pot4 kernel takes for these CUDA operands (an output
    from ``torch.empty``, as the wrapper's, is 16-byte aligned)."""
    m, k = x_q.shape
    return _device_plan_pot4((m, n, k, _align(x_q.data_ptr()), 16, _sms(x_q.device)),
                             x_q.device)[0]


class Pot4Launch(ctypes.Structure):
    """The arguments of one pot4 kernel launch but X and the output
    (``csrc/shift_matmul.cu``: Pot4Launch): the weight's pointers (the
    packed codes prepared K-major, row stride ``ldw``), the split-K
    workspace and the plan."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("wt", "es", "eb", "ws", "counters")]
                + [(f, ctypes.c_int) for f in ("m", "n", "k", "ldx", "ldw", "relu", "bm", "bn",
                                                "avec", "ovec", "splits", "per", "grid")])


def pot4_launch(packed, ld: int, eff_scale, eff_bias, relu: bool, m: int, k: int,
                p: Pot4Plan, ws, counters) -> Pot4Launch:
    """The launch of plan ``p`` on these operands (``packed`` prepared, row
    stride ``ld``). X's rows are ``ldx`` apart: K, or round_up(K, 16) where
    the plan copies no 4 bytes of X (``_call_pot4`` then copies X to a
    16-byte aligned buffer of such rows)."""
    return Pot4Launch(packed.data_ptr(), eff_scale.data_ptr(), eff_bias.data_ptr(),
                      ws.data_ptr(), counters.data_ptr(), m, packed.shape[1], k,
                      k if p.avec else _roundup(k, 16), ld, int(relu), p.bm, p.bn,
                      p.avec or 16, p.ovec, p.splits, p.per, p.grid)


def _call_pot4(x_q, launch: Pot4Launch, pad: bool) -> torch.Tensor:
    """One launch of the pot4 kernel as ``launch`` lays it out; ``pad``
    where its plan copies no 4 bytes of X (``Pot4Plan.avec`` 0)."""
    if pad:  # X's rows take no 4-byte copy: a zero-padded, aligned copy of X
        x_q = F.pad(x_q, (0, launch.ldx - launch.k))
    y = torch.empty((launch.m, launch.n), dtype=torch.int8, device=x_q.device)
    rc = _lib().tf2_qmatmul_pot4(x_q.data_ptr(), y.data_ptr(), ctypes.addressof(launch),
                                 build.raw_stream(x_q.device))
    build.check_launch(rc, "qmatmul_pot4")
    LAUNCHES["qmatmul_pot4"] += 1
    return y


# The pot4 wrapper's launches, laid out once for each weight (its packed
# codes, es and eb, by identity), X's shape and alignment, relu and device:
# key -> (weak references to the three, their data pointers, the launch,
# whether it pads X).
# An entry leaves with any of the three tensors, and is taken only while
# all three are alive and still at those pointers.
_POT4_LAUNCHES: dict[tuple, tuple] = {}


def _check_packing(k: int, packed) -> None:
    if k % 2 or packed.shape[0] * 2 != k:
        raise ValueError(f"split-half packing mismatch: K={k} rows={packed.shape[0]}")


def _pot4_entry(key, x_q, packed, eff_scale, eff_bias, relu, x_align: int) -> tuple:
    """Check every operand of a launch and lay it out; remembered in
    ``_POT4_LAUNCHES`` where the codes were given prepared (a weight
    prepared on the call is prepared, and counted, on every call)."""
    m, k = x_q.shape
    _check_packing(k, packed)
    n = packed.shape[1]
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, (m, k)),
                         eff_scale=(eff_scale, torch.float32, (n,)),
                         eff_bias=(eff_bias, torch.float32, (n,)))
    if packed.device != x_q.device:
        raise ValueError(f"w on {packed.device}, expected {x_q.device}")
    if packed.dtype != torch.uint8:
        raise ValueError(f"w has dtype {packed.dtype}, expected {torch.uint8}")
    ld = prepared_ld(packed)
    keep = ld is not None
    if not keep:
        packed = prepare_weight(packed)
        ld = packed.stride(1)
        PREPARED_PER_CALL["qmatmul_pot4"] += 1
    # the output, from torch.empty, is 16-byte aligned
    p, ws, counters = _device_plan_pot4((m, n, k, x_align, 16, _sms(x_q.device)), x_q.device)
    launch = pot4_launch(packed, ld, eff_scale, eff_bias, relu, m, k, p, ws, counters)
    ptrs = (packed.data_ptr(), eff_scale.data_ptr(), eff_bias.data_ptr())
    if not keep:  # the launch holds the prepared copy until it is queued
        return None, None, None, ptrs, launch, not p.avec, packed
    drop = lambda _, key=key: _POT4_LAUNCHES.pop(key, None)  # noqa: E731
    entry = (weakref.ref(packed, drop), weakref.ref(eff_scale, drop),
             weakref.ref(eff_bias, drop), ptrs, launch, not p.avec, ws, counters)
    _POT4_LAUNCHES[key] = entry
    return entry


def _launch_pot4(x_q, packed, eff_scale, eff_bias, relu):
    m, k = x_q.shape
    device = x_q.device
    x_align = _align(x_q.data_ptr())
    key = (id(packed), id(eff_scale), id(eff_bias), m, k, x_align, bool(relu), device)
    e = _POT4_LAUNCHES.get(key)
    if (e is None or device.index != torch._C._cuda_getDevice()
            or x_q.dtype != torch.int8 or not x_q.is_contiguous()
            or e[0]() is not packed or e[1]() is not eff_scale or e[2]() is not eff_bias
            or e[3] != (packed.data_ptr(), eff_scale.data_ptr(), eff_bias.data_ptr())):
        e = _pot4_entry(key, x_q, packed, eff_scale, eff_bias, relu, x_align)
    return _call_pot4(x_q, e[4], e[5])


def _launch_int8(x_q, w_q, eff_scale, eff_bias, relu, residual):
    m, k = x_q.shape
    if w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"w has shape {tuple(w_q.shape)}, expected ({k}, N)")
    n = w_q.shape[1]
    operands = dict(x_q=(x_q, torch.int8, (m, k)),
                    eff_scale=(eff_scale, torch.float32, (n,)),
                    eff_bias=(eff_bias, torch.float32, (n,)))
    if residual is not None:
        operands["residual"] = (residual[0], torch.int8, (m, n))
    build.check_operands(x_q.device, **operands)
    if w_q.device != x_q.device:
        raise ValueError(f"w on {w_q.device}, expected {x_q.device}")
    if w_q.dtype != torch.int8:
        raise ValueError(f"w has dtype {w_q.dtype}, expected {torch.int8}")
    ld = prepared_ld(w_q)
    if ld is None:
        w_q = prepare_weight(w_q)
        ld = w_q.stride(1)
        PREPARED_PER_CALL["qmatmul_int8"] += 1
    y = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    p, ws, counters = _device_plan(_plan_key(x_q, y, residual), x_q.device)
    kk = k
    if not p.avec:  # X's rows take no 4-byte copy: zero-pad them to 16 bytes
        kk = _roundup(k, 16)
        x_q = F.pad(x_q, (0, kk - k))
    r_ptr, scale = (None, 0.0) if residual is None else (residual[0].data_ptr(), residual[1])
    rc = _lib().tf2_qmatmul_int8(
        x_q.data_ptr(), w_q.data_ptr(), ld, eff_scale.data_ptr(), eff_bias.data_ptr(), r_ptr,
        y.data_ptr(), m, n, kk, int(relu), build.f32(scale), p.tile, p.avec or 16, p.ovec,
        ws.data_ptr(), counters.data_ptr(), p.splits,
        build.raw_stream(x_q.device))
    build.check_launch(rc, "qmatmul_int8")
    LAUNCHES["qmatmul_int8"] += 1
    return y


def qmatmul_pot4(x_q: torch.Tensor, packed: torch.Tensor, eff_scale: torch.Tensor,
                 eff_bias: torch.Tensor, relu: bool = False, residual=None) -> torch.Tensor:
    """x_q (M, K) int8 . packed (K/2, N) uint8 -> (M, N) int8. ``packed``
    may be (and on the Engine's path is) ``prepare_weight``'s view; any
    other (K/2, N) tensor is prepared on the call (``PREPARED_PER_CALL``).
    The kernel has no residual epilogue: on the card a residual raises (the
    Engine decodes such weights to int8 at load)."""
    if x_q.device.type == "cpu":
        _check_packing(x_q.shape[1], packed)
        return qmatmul_pot4_plain(x_q, packed, eff_scale, eff_bias, relu, residual)
    if residual is not None:
        raise ValueError("qmatmul_pot4 kernel: no residual epilogue; decode the "
                         "weights to int8 for qmatmul_int8")
    return _launch_pot4(x_q, packed, eff_scale, eff_bias, relu)


def qmatmul_int8(x_q: torch.Tensor, w_q: torch.Tensor, eff_scale: torch.Tensor,
                 eff_bias: torch.Tensor, relu: bool = False, residual=None) -> torch.Tensor:
    """x_q (M, K) int8 . w_q (K, N) int8 -> (M, N) int8; ``residual`` is
    (r_q (M, N) int8, its scale) or None. ``w_q`` may be (and on the
    Engine's path is) ``prepare_weight``'s view; any other (K, N) tensor is
    prepared on the call (``PREPARED_PER_CALL``)."""
    if x_q.device.type == "cpu":
        return qmatmul_int8_plain(x_q, w_q, eff_scale, eff_bias, relu, residual)
    return _launch_int8(x_q, w_q, eff_scale, eff_bias, relu, residual)


def fused_qmatmul(x_q, wparam, eff_scale, eff_bias, relu: bool, wfmt: str,
                  plain: bool = False, residual=None) -> torch.Tensor:
    """Dispatch entry: the kernel for ``wfmt`` ("pot4" packed codes or
    "int8" (K, N) weights), or its plain version when ``plain``."""
    if wfmt == "pot4":
        fn = qmatmul_pot4_plain if plain else qmatmul_pot4
    else:
        fn = qmatmul_int8_plain if plain else qmatmul_int8
    return fn(x_q, wparam, eff_scale, eff_bias, relu, residual)
