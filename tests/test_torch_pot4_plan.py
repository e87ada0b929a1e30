"""The pot4 GEMM's launch plan (``tf2_tpu_torch/kernels/shift_matmul.py:
plan_pot4``), its K-major packed codes and its slab, on the CPU: at every
pot4 GEMM shape of the zoo (ResNet-50, GoogLeNet and SqueezeNet v1.1 at
batch 64 and 1, default and fused or merged) and at ragged ones, the tiles
cover the output exactly once, the splits cover K exactly once, the
persistent blocks take every work item once, the slab, ring and epilogue
fit the shared memory (``csrc/qmm_pot4.cuh``), and every variant of the
plan is some shape's choice; ``prepare_weight`` gives the original codes;
a numpy model of the kernel's slab fill (which byte and nibble lands at
which swizzled B^T position) rebuilds ``potq.pot_decode``; a numpy model
of its conversion-free epilogue equals ``shift_matmul.epilogue``; the plain
version on prepared codes equals the reference's jnp route
(``tf2_tpu/kernels/dispatch.py``: ``decode_weight`` and ``_epilogue``); a
CPU Engine holds the pot4 GEMM weights prepared. Tolerance 0. The kernel
itself is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph.ir import Node as RefNode
from tf2_tpu.kernels import dispatch as ref_dispatch
from tf2_tpu_torch.kernels import dispatch, shift_matmul
from tf2_tpu_torch.transform import potq

SMS = 132
# (M per image, K, N): launches a forward of every pot4 GEMM (1x1 stride-1
# convs and dense layers) of the zoo's Engines
ZOO = {
    "resnet50": [((49, 512, 2048), 3), ((49, 2048, 512), 2), ((196, 256, 1024), 6),
                 ((196, 1024, 256), 5), ((196, 1024, 512), 1), ((784, 128, 512), 4),
                 ((784, 512, 128), 3), ((784, 512, 256), 1), ((3136, 64, 64), 1),
                 ((3136, 64, 256), 4), ((3136, 256, 64), 2), ((3136, 256, 128), 1)],
    "googlenet": [((49, 832, 32), 1), ((49, 832, 48), 1), ((49, 832, 128), 2),
                  ((49, 832, 160), 1), ((49, 832, 192), 1), ((49, 832, 256), 1),
                  ((49, 832, 384), 1), ((196, 480, 16), 1), ((196, 480, 64), 1),
                  ((196, 480, 96), 1), ((196, 480, 192), 1), ((196, 512, 24), 2),
                  ((196, 512, 32), 1), ((196, 512, 64), 3), ((196, 512, 112), 2),
                  ((196, 512, 128), 2), ((196, 512, 144), 1), ((196, 512, 160), 1),
                  ((196, 528, 32), 1), ((196, 528, 128), 1), ((196, 528, 160), 1),
                  ((196, 528, 256), 1), ((784, 192, 16), 1), ((784, 192, 32), 1),
                  ((784, 192, 64), 1), ((784, 192, 96), 1), ((784, 256, 32), 1),
                  ((784, 256, 64), 1), ((784, 256, 128), 2), ((3136, 64, 64), 1)],
    "googlenet merge_1x1": [((49, 832, 128), 2), ((196, 480, 64), 1), ((196, 512, 64), 3),
                            ((196, 528, 128), 1), ((784, 192, 32), 1), ((784, 256, 64), 1),
                            ((3136, 64, 64), 1)],
    "squeezenet_v1_1": [((169, 48, 192), 2), ((169, 64, 256), 2), ((169, 256, 48), 1),
                        ((169, 384, 48), 1), ((169, 384, 64), 1), ((169, 512, 64), 1),
                        ((729, 32, 128), 2), ((729, 128, 32), 1), ((729, 256, 32), 1),
                        ((3025, 16, 64), 2), ((3025, 64, 16), 1), ((3025, 128, 16), 1)],
    "squeezenet_v1_1 merge_1x1": [((169, 48, 192), 2), ((169, 64, 256), 2),
                                  ((169, 256, 48), 1), ((169, 384, 48), 1),
                                  ((169, 384, 64), 1), ((169, 512, 64), 1),
                                  ((729, 128, 32), 1), ((729, 256, 32), 1),
                                  ((3025, 64, 16), 1), ((3025, 128, 16), 1)],
}
# (M, K, N, X's address alignment): K = 2, 16, 48 and 2 * odd, N = 1, 16,
# 24, 48 and 1000, X at every alignment, M = 1 and 63, a K * BN too large
# for one slab (chip_smoke.py: RAGGED_POT4)
RAGGED = [(1, 2, 1, 16), (63, 16, 16, 16), (63, 48, 24, 16), (100, 34, 48, 16),
          (130, 50, 1000, 16), (1, 2048, 1000, 16), (63, 96, 200, 8), (300, 200, 130, 4),
          (70, 64, 36, 2), (65, 66, 99, 1), (20000, 4608, 128, 16), (4096, 256, 1024, 16)]


def _zoo_shapes():
    shapes = set()
    for rows in ZOO.values():
        for (m, k, n), _ in rows:
            shapes |= {(m, k, n), (64 * m, k, n)}
    return sorted(shapes)


def test_zoo_lists_are_the_engines_pot4_gemms():
    """GoogLeNet's and SqueezeNet's lists above are their CPU Engines'
    pot4 GEMMs. ResNet-50's, its 1x1 stride-1 convs stage by stage (33 a
    forward), are not rebuilt here: its artifact takes longer to build than
    the rest of this file runs."""
    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    assert sum(c for _, c in ZOO["resnet50"]) == 33
    for name in ("googlenet", "squeezenet_v1_1"):
        art = synthetic_quantized(name, seed=0, batch=1)
        for label, flags in (("", {}), (" merge_1x1", {"merge_1x1": True})):
            eng = Engine(art.graph, art.params, device="cpu", **flags)
            shapes = activation_shapes(eng.graph, eng.params)
            counts = {}
            for n in eng.graph.nodes:
                if dispatch.runs_gemm(n, "pot4"):
                    x = shapes[n.inputs[0]]
                    key = (int(np.prod(x[:-1])), x[-1], n.attrs["kshape"][-1])
                    counts[key] = counts.get(key, 0) + 1
            assert sorted(counts.items()) == sorted(ZOO[name + label])


def _items_of_blocks(p):
    """Each block's run of work items (csrc/qmm_pot4.cuh: i_begin, i_end)."""
    return [(b * p.items // p.grid, (b + 1) * p.items // p.grid) for b in range(p.grid)]


def _check(m, k, n, x_align=16, o_align=16):
    p = shift_matmul.plan_pot4(m, n, k, x_align, o_align, SMS)
    assert p.bm in (64, 128) and p.bn in shift_matmul.POT4_BN
    # the tiles cover [0, M) x [0, N) exactly once
    rows, cols = np.zeros(m, np.int32), np.zeros(n, np.int32)
    for i in range(p.mtiles):
        rows[i * p.bm:(i + 1) * p.bm] += 1
    for j in range(p.ntiles):
        cols[j * p.bn:(j + 1) * p.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    # the splits cover the K steps exactly once, none empty
    assert p.steps == -(-k // 64)
    steps = np.zeros(p.steps, np.int32)
    for z in range(p.splits):
        lo, hi = z * p.per, min(p.steps, (z + 1) * p.per)
        assert lo < hi
        steps[lo:hi] += 1
    assert (steps == 1).all()
    # every block takes a non-empty run of items; together each item once
    runs = _items_of_blocks(p)
    assert all(lo < hi for lo, hi in runs)
    assert runs[0][0] == 0 and runs[-1][1] == p.items
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert p.items == p.ntiles * p.splits * p.mtiles and p.grid <= SMS * p.blocks_per_sm
    # shared memory: the slab (per steps of [BN][64]), the ring, the output
    # tile and es/eb fit one block; blocks_per_sm of them fit an SM
    assert p.smem == (p.per * p.bn * 64 + 4 * p.bm * 64 + p.bm * (p.bn + 16) + 8 * p.bn)
    assert p.smem <= shift_matmul.SMEM_BLOCK
    assert p.blocks_per_sm * (p.smem + 1024 + 16) <= shift_matmul.SMEM_SM
    assert p.blocks_per_sm * 2 * p.bm <= 2048  # threads an SM
    # workspace: a tile of int32 sums for each split, a counter a tile
    tiles = p.mtiles * p.ntiles
    assert p.ws_ints == (p.splits * tiles * p.bm * p.bn if p.splits > 1 else 0)
    assert p.counters == (tiles if p.splits > 1 else 0)
    assert (p.splits > 1) == (p.split_for != "")
    # copy widths: the largest of 16, 8, 4 dividing K and X's address (0:
    # the wrapper pads X), the largest of 16 .. 1 dividing N and the output
    assert p.avec == next((v for v in (16, 8, 4) if k % v == 0 and x_align % v == 0), 0)
    assert p.ovec == next(v for v in (16, 8, 4, 2, 1) if n % v == 0 and o_align % v == 0)
    return p


@pytest.mark.parametrize("shape", _zoo_shapes(), ids=str)
def test_plan_pot4_at_zoo_shapes(shape):
    m, k, n = shape
    p = _check(m, k, n)
    assert p.avec == 16 and p.ovec in (16, 8)
    if m >= 12544 and n <= 64:  # no wave split where tiles alone fill the card
        assert p.split_for == ""


@pytest.mark.parametrize("shape", RAGGED, ids=str)
def test_plan_pot4_at_ragged_shapes(shape):
    m, k, n, x_align = shape
    _check(m, k, n, x_align)


def test_every_pot4_variant_is_reached():
    """Each tile height and width, X copy width, output copy width and kind
    of split is some zoo or ragged shape's choice (chip_smoke.py runs them
    all on the card and requires each)."""
    plans = [shift_matmul.plan_pot4(m, n, k) for m, k, n in _zoo_shapes()]
    plans += [shift_matmul.plan_pot4(m, n, k, xa) for m, k, n, xa in RAGGED]
    assert {p.bm for p in plans} == {64, 128}
    assert {p.bn for p in plans} == set(shift_matmul.POT4_BN)
    assert {p.avec for p in plans} == {0, 4, 8, 16}
    assert {p.ovec for p in plans} == {1, 2, 4, 8, 16}
    assert {p.split_for for p in plans} == {"", "slab", "wave"}
    assert {p.blocks_per_sm for p in plans} >= {1, 2, 3}


@pytest.mark.parametrize("k,n", [(2, 1), (16, 24), (48, 200), (34, 5), (528, 32), (2048, 64)])
def test_prepare_weight_keeps_the_codes(k, n):
    """The K-major view of the packed codes equals the original (K/2, N)
    codes, over rows of round_up(K/2, 16) bytes, zero past K/2."""
    codes = np.random.default_rng(k + n).integers(0, 16, (k, n)).astype(np.uint8)
    packed = torch.as_tensor(potq.pack_codes(codes))
    wp = shift_matmul.prepare_weight(packed)
    ld = -(-(k // 2) // 16) * 16
    assert torch.equal(wp, packed) and wp.dtype == torch.uint8 and wp.shape == (k // 2, n)
    assert wp.stride() == (1, ld) and shift_matmul.prepared_ld(wp) == ld
    rows = torch.as_strided(wp, (n, ld), (ld, 1))
    assert torch.equal(rows[:, :k // 2], packed.t()) and not rows[:, k // 2:].any()
    assert shift_matmul.prepared_ld(packed) is None or n == 1  # N-major: prepared per call
    assert torch.equal(potq.unpack_codes(wp, k), torch.as_tensor(codes))


def _swz64(row, chunk):
    """csrc/hopper.cuh: swz64."""
    return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4)


def _decode(c):
    return potq.pot_decode_np(np.asarray(c, np.uint8)).astype(np.int8)


def _slab_model(rows: np.ndarray, k: int, n: int, bn: int, n0: int, s0: int, ns: int):
    """The bytes csrc/qmm_pot4.cuh's fill writes for the slab of channels
    n0 .. n0 + BN and K steps s0 .. s0 + ns, from the K-major packed rows
    (N, ld): per step, chunk idx of row idx >> 2, codes k0 = 64 step + 16
    (idx & 3) ..: 16 low nibbles of bytes k0 .. (mode 1), 16 high nibbles of
    bytes k0 - K/2 .. (mode 2), else word by word (decode_word), zero past
    N or K; each chunk at swz64(row, idx & 3) of its step."""
    kh = k // 2
    slab = np.zeros(ns * bn * 64, np.int8)
    for s in range(ns):
        for idx in range(bn * 4):
            row_n, c = idx >> 2, idx & 3
            k0 = (s0 + s) * 64 + 16 * c
            chunk = np.zeros(16, np.int8)
            if n0 + row_n < n and k0 < k:
                row = rows[n0 + row_n]
                if k0 + 16 <= kh:
                    chunk = _decode(row[k0:k0 + 16] & 15)
                elif k0 >= kh and k0 + 16 <= k and (k0 - kh) % 16 == 0:
                    chunk = _decode(row[k0 - kh:k0 - kh + 16] >> 4)
                else:
                    for w in range(4):
                        kw = k0 + 4 * w
                        if kw + 4 <= kh:
                            chunk[4 * w:4 * w + 4] = _decode(row[kw:kw + 4] & 15)
                        elif kw >= kh and kw + 4 <= k and (kw - kh) % 4 == 0:
                            chunk[4 * w:4 * w + 4] = _decode(row[kw - kh:kw - kh + 4] >> 4)
                        else:
                            for b in range(4):
                                kk = kw + b
                                code = row[kk] & 15 if kk < kh else (
                                    row[kk - kh] >> 4 if kk < k else 0)
                                chunk[4 * w + b] = _decode(code)
            off = s * bn * 64 + _swz64(row_n, c)
            slab[off:off + 16] = chunk
    return slab


@pytest.mark.parametrize("m,k,n", [(300, 64, 256), (63, 48, 24), (63, 16, 16), (1, 2, 1),
                                   (100, 34, 48), (784, 528, 32), (3136, 2048, 512),
                                   (20000, 4608, 128)])
def test_slab_model_rebuilds_pot_decode(m, k, n):
    """For each slab a plan fills (every N-tile, every K split), the fill
    model's bytes, read back through the swizzle, are the decoded codes
    B^T[n][k] in natural k order, zero past N and K."""
    codes = np.random.default_rng(k * n).integers(0, 16, (k, n)).astype(np.uint8)
    wp = shift_matmul.prepare_weight(torch.as_tensor(potq.pack_codes(codes)))
    ld = wp.stride(1)
    rows = torch.as_strided(wp, (n, ld), (ld, 1)).numpy()
    want = potq.pot_decode_np(codes).T  # (N, K)
    p = shift_matmul.plan_pot4(m, n, k)
    kk = np.arange(64)
    for nt in range(p.ntiles):
        for z in range(p.splits):
            s0, ns = z * p.per, min(p.steps - z * p.per, p.per)
            slab = _slab_model(rows, k, n, p.bn, nt * p.bn, s0, ns)
            for s in range(ns):
                for r in range(p.bn):
                    pos = s * p.bn * 64 + _swz64(r, kk >> 4) + (kk & 15)
                    ks, ch = (s0 + s) * 64 + kk, nt * p.bn + r
                    exp = np.where(ks < k, want[min(ch, n - 1)][np.minimum(ks, k - 1)], 0)
                    exp = exp if ch < n else np.zeros(64)
                    np.testing.assert_array_equal(slab[pos], exp.astype(np.int8))


MAGIC = np.float32(12582912.0)  # 1.5 * 2^23


def _small_f32(acc):
    """csrc/qmm_pot4.cuh: requant_byte's int -> f32 where small: the bits
    of 1.5 * 2^23 plus acc, read as a float, less 1.5 * 2^23."""
    return (np.int32(0x4B400000) + acc.astype(np.int32)).view(np.float32) - MAGIC


def _requant_byte(acc, es, eb, relu):
    """csrc/qmm_pot4.cuh: requant_byte in numpy f32 (each operation rounded
    to f32): acc to f32 through the constant 1.5 * 2^23 (|acc| <= 2^22),
    * es, + eb, the clip to [0 or -127, 127], the rounding by adding
    1.5 * 2^23, the low byte."""
    f = _small_f32(acc)
    v = np.minimum(np.maximum(f * es + eb, np.float32(0.0 if relu else -127.0)),
                   np.float32(127.0))
    return ((v + MAGIC).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("relu", [False, True])
def test_conversion_free_epilogue_equals_epilogue(relu):
    """requant_byte's function equals the plain epilogue on accumulators up
    to the small bound (|acc| <= 2^22), at scales that put outputs on and
    near every rounding boundary and past both clips."""
    rng = np.random.default_rng(int(relu))
    acc = np.concatenate([rng.integers(-(1 << 22), (1 << 22) + 1, 200000),
                          np.arange(-3000, 3000), [-(1 << 22), 1 << 22]]).astype(np.int32)
    eb = rng.normal(0, 3, acc.size).astype(np.float32)
    for es in (np.float32(0.5), np.float32(1e-3), np.float32(2.0 ** -14)):
        got = _requant_byte(acc, es, eb, relu)
        want = shift_matmul.epilogue(torch.as_tensor(acc), torch.as_tensor(es),
                                     torch.as_tensor(eb), relu)
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("k", [510, 512, 514, 516])
def test_small_conversion_holds_every_accumulator_of_its_k(k):
    """The kernel converts through 1.5 * 2^23 where 128 * 64 * K <= 2^22
    (csrc/shift_matmul.cu: small): exact on all of [-2^22, 2^22], which
    holds every accumulator of such a K (|x| <= 128, x = -128 included;
    |w| <= 64), and wrong just past it, so a larger K must not take it."""
    bound = 1 << 22
    edge = np.concatenate([np.arange(-bound, -bound + 64), np.arange(bound - 63, bound + 1)])
    np.testing.assert_array_equal(_small_f32(edge), edge.astype(np.float32))
    past = np.array([-bound - 2, -bound - 1, bound + 1, bound + 2])
    assert (_small_f32(past) != past.astype(np.float32)).all()
    acc_max = 128 * 64 * k
    small = 128 * 64 * k <= bound
    assert small == (k <= 512)
    if small:
        extremes = np.array([-acc_max, acc_max])
        np.testing.assert_array_equal(_small_f32(extremes), extremes.astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(64, 384, 192), (33, 50, 20), (1, 2048, 1000), (70, 34, 33)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_on_prepared_codes_matches_reference(m, k, n, relu):
    """qmatmul_pot4 on the CPU (its plain version) on the prepared codes
    equals the reference's jnp route: decode_weight, an int32 matmul,
    _epilogue."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    packed = potq.pack_codes(rng.randint(0, 16, (k, n)).astype(np.uint8))
    es = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    eb = rng.randn(n).astype(np.float32)
    node = RefNode("fc", "qdense", ("x",), ("fc.wp", "fc.es", "fc.eb"),
                   {"kshape": [k, n], "wfmt": "pot4", "relu": relu})
    w = ref_dispatch.decode_weight(node, {"fc.wp": jnp.asarray(packed)})
    acc = jnp.matmul(jnp.asarray(x, jnp.int32), w.astype(jnp.int32))
    want = ref_dispatch._epilogue(acc, jnp.asarray(es), jnp.asarray(eb), relu)
    wp = shift_matmul.prepare_weight(torch.as_tensor(packed))
    got = shift_matmul.qmatmul_pot4(torch.as_tensor(x), wp, torch.as_tensor(es),
                                    torch.as_tensor(eb), relu=relu)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_holds_pot4_gemm_weights_prepared():
    """The CPU Engine of a small ResNet-50 holds every pot4 GEMM weight (the
    1x1 stride-1 convs) K-major, a view of the param's shape equal to the
    artifact's, and leaves the other pot4 convs' codes as they are."""
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("resnet50", seed=0, batch=1, image=32, classes=10,
                              depths=(1, 1, 1, 1))
    eng = Engine(art.graph, art.params, device="cpu", block_fusion=False)
    gemms = [n for n in eng.graph.nodes if dispatch.runs_gemm(n, "pot4")]
    convs = [n for n in eng.graph.nodes
             if n.op == "qconv2d" and n.attrs.get("wfmt") == "pot4" and n not in gemms]
    assert len(gemms) == 9 and convs  # c1 and c3 of each block, stage 1's downsample
    for n in gemms:
        w = eng.params[n.params[0]]
        assert w.dtype == torch.uint8 and shift_matmul.prepared_ld(w) is not None
        assert tuple(w.shape) == tuple(art.params[n.params[0]].shape)
        np.testing.assert_array_equal(w.numpy(), np.asarray(art.params[n.params[0]]))
    for n in convs:
        assert eng.params[n.params[0]].is_contiguous()
