"""The int8 GEMM's launch plan (``tf2_tpu_torch/kernels/shift_matmul.py:
plan``) and its K-major weights, on the CPU: at every int8 GEMM shape of
the zoo (the CNN fcs, SqueezeNet's int8 classifier conv, GoogLeNet's merged
1x1s, ViT-B/16's five dense shapes at batch 64 and 1) and at ragged ones,
the tiles cover the output exactly once, the splits cover K exactly once,
the workspace and shared memory are what the kernel
(``csrc/qmm_int8.cuh``) takes, and the copy widths follow the alignment;
``prepare_weight`` gives the transposed original, and the plain version on
prepared weights equals the reference's non-Pallas int8 GEMM (the int32
``jnp.dot`` and epilogue tests/kernels/test_shift_matmul.py holds
``qmatmul_int8``, ``tf2_tpu/kernels/shift_matmul.py:123``, against; no
Pallas interpret mode). Tolerance 0. The kernel itself is
held against the plain version on the card in tests/test_torch_cuda.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu_torch.kernels import dispatch, shift_matmul

SMS = 132
# (M, K, N) at batch 64; ViT's tokens: 196 (vit_b16) and 197 (vit_b16_cls)
ZOO_B64 = [(64, 2048, 1000), (64, 1024, 1000), (64 * 169, 512, 1000)]
for _t in (196, 197):
    ZOO_B64 += [(64 * _t, 768, 2304), (64 * _t, 768, 768), (64 * _t, 768, 3072),
                (64 * _t, 3072, 768)]
ZOO_B64.append((64, 768, 1000))
RAGGED = [(1, 48, 16), (100, 64, 130), (130, 48, 200), (300, 200, 130), (33, 196, 99),
          (33, 50, 20), (16, 64, 8464), (2048, 192, 1024), (4096, 256, 1024),
          (7, 3, 5), (129, 1000, 1)]


def _ref_qmm(x_q, w_q, es, eb, relu):
    """tests/kernels/test_shift_matmul.py's reference: int32 dot + epilogue."""
    acc = jnp.dot(jnp.asarray(x_q, jnp.int32), jnp.asarray(w_q, jnp.int32),
                  preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(es)[None, :] + jnp.asarray(eb)[None, :]
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _googlenet_merged_shapes():
    """(M, K, N) of every int8 GEMM of GoogLeNet's merge_1x1 Engine at batch
    1 (the merged sibling 1x1s and the fc), from the CPU Engine's graph."""
    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("googlenet", seed=0, batch=1)
    eng = Engine(art.graph, art.params, device="cpu", merge_1x1=True)
    shapes = activation_shapes(eng.graph, eng.params)
    out = []
    for n in eng.graph.nodes:
        if dispatch.runs_gemm(n, "int8"):
            x = shapes[n.inputs[0]]
            out.append((int(np.prod(x[:-1])), x[-1], n.attrs["kshape"][-1]))
    return out


def _zoo_shapes():
    shapes = list(ZOO_B64)
    shapes += [(m // 64, k, n) for m, k, n in ZOO_B64]           # batch 1
    merged = _googlenet_merged_shapes()
    shapes += merged + [(64 * m, k, n) for m, k, n in merged]
    return sorted(set(shapes))


def test_zoo_has_googlenets_merged_gemms():
    merged = _googlenet_merged_shapes()
    assert len(merged) == 10 and (1, 1024, 1000) in merged
    assert all(k % 16 == 0 for _, k, _ in merged)


def _check_plan(m, k, n, x_align=16, o_align=16):
    p = shift_matmul.plan(m, n, k, x_align, o_align, SMS)
    assert (p.bm, p.bn) == shift_matmul.TILES[p.tile]
    # the tiles cover [0, M) x [0, N) exactly once
    rows = np.zeros(m, np.int32)
    cols = np.zeros(n, np.int32)
    for i in range(p.grid[0]):
        rows[i * p.bm:(i + 1) * p.bm] += 1
    for j in range(p.grid[1]):
        cols[j * p.bn:(j + 1) * p.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert (p.grid[0] - 1) * p.bm < m and (p.grid[1] - 1) * p.bn < n
    # the splits cover the K steps exactly once, none empty
    kk = k if p.avec else -(-k // 16) * 16
    assert p.steps == -(-kk // shift_matmul.BK) and p.grid[2] == p.splits
    steps = np.zeros(p.steps, np.int32)
    for z in range(p.splits):
        lo, hi = z * p.per, min(p.steps, (z + 1) * p.per)
        assert lo < hi
        steps[lo:hi] += 1
    assert (steps == 1).all()
    # split-K where the grid is under one wave, with runs of 4 steps or more
    blocks = p.grid[0] * p.grid[1]
    assert (p.splits > 1) == (blocks < SMS and p.steps >= 8)
    assert p.splits == 1 or p.per >= 4
    # the workspace: a tile of int32 sums for each split, a counter a tile
    assert p.ws_ints == (p.splits * blocks * p.bm * p.bn if p.splits > 1 else 0)
    assert p.counters == (blocks if p.splits > 1 else 0)
    # shared memory: the 6-slot ring, which holds the epilogue's two tiles,
    # two blocks an SM
    ring = 6 * (p.bm + p.bn) * shift_matmul.BK
    assert shift_matmul.stages(p.bm, p.bn) == 6
    assert p.smem == ring >= 2 * p.bm * (p.bn + 16)
    assert p.smem <= 232448 // 2 - 1024
    return p


@pytest.mark.parametrize("shape", _zoo_shapes(), ids=str)
def test_plan_at_zoo_shapes(shape):
    m, k, n = shape
    p = _check_plan(m, k, n)
    assert p.avec == 16 and p.ovec == (16 if n % 16 == 0 else 8)
    if m >= 64 * 196:  # ViT (and GoogLeNet's merged 1x1s) at batch 64: 128 x 128 tiles
        assert p.name.startswith("128x128") and p.splits == 1
    if (m, k, n) == (64, 2048, 1000):  # the fc: 16 tiles of 64 x 64, 8 splits
        assert p.name == "64x64 a16 o8 split8" and p.grid == (1, 16, 8)


@pytest.mark.parametrize("shape", RAGGED, ids=str)
def test_plan_at_ragged_shapes(shape):
    _check_plan(*shape)


@pytest.mark.parametrize("k,x_align,avec", [(64, 16, 16), (200, 16, 8), (196, 16, 4),
                                            (64, 8, 8), (64, 4, 4), (50, 16, 0),
                                            (64, 2, 0), (3, 16, 0)])
def test_copy_width_of_x(k, x_align, avec):
    """X's copies: the largest of 16, 8, 4 dividing K and X's address;
    none (the wrapper pads X's rows to 16 bytes) otherwise."""
    p = shift_matmul.plan(100, 64, k, x_align)
    assert p.avec == avec
    assert p.name.split()[1] == f"a{avec or 'pad'}"


@pytest.mark.parametrize("n,o_align,ovec", [(1000, 16, 8), (768, 16, 16), (130, 16, 2),
                                            (99, 16, 1), (20, 16, 4), (768, 4, 4)])
def test_copy_width_of_the_output(n, o_align, ovec):
    assert shift_matmul.plan(64, n, 64, 16, o_align).ovec == ovec


def test_every_tile_is_taken():
    """Each of the four tiles is some shape's choice (the card tests and
    chip_smoke.py run each)."""
    picks = {shift_matmul.plan(m, n, k).tile for m, k, n in _zoo_shapes() + RAGGED}
    assert picks == set(range(len(shift_matmul.TILES)))


@pytest.mark.parametrize("k,n", [(64, 48), (50, 20), (3, 2), (2048, 1000), (768, 2304)])
def test_prepare_weight_is_the_transposed_original(k, n):
    w = torch.as_tensor(np.random.default_rng(k + n).integers(-127, 128, (k, n), dtype=np.int8))
    wp = shift_matmul.prepare_weight(w)
    ld = -(-k // 16) * 16
    assert torch.equal(wp, w) and wp.shape == (k, n)
    assert wp.stride() == (1, ld) and shift_matmul.prepared_ld(wp) == ld
    rows = torch.as_strided(wp, (n, ld), (ld, 1))
    assert torch.equal(rows[:, :k], w.t()) and not rows[:, k:].any()
    assert shift_matmul.prepared_ld(w) is None  # N-major: prepared on each call
    # K-major but with rows of K bytes: taken as prepared where K % 16 == 0
    assert (shift_matmul.prepared_ld(w.t().contiguous().t()) is not None) == (k % 16 == 0)
    assert n == 1 or shift_matmul.prepared_ld(wp[:, : n - 1]) == ld


def test_prepared_ld_refuses_short_rows():
    """A K-major view whose rows end before round_up(K, 16) in memory is
    not taken as prepared."""
    rows = torch.zeros((4, 32), dtype=torch.int8)
    assert shift_matmul.prepared_ld(rows[:, :20].t()) == 32
    short = torch.zeros(3 * 32 + 20, dtype=torch.int8).as_strided((20, 4), (1, 32))
    assert shift_matmul.prepared_ld(short) is None


@pytest.mark.parametrize("m,k,n", [(64, 384, 192), (33, 50, 20), (1, 2048, 1000)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_on_prepared_weights_matches_reference(m, k, n, relu):
    rng = np.random.RandomState(m + k)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    es = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    eb = rng.randn(n).astype(np.float32)
    want = _ref_qmm(x, w, es, eb, relu)
    wp = shift_matmul.prepare_weight(torch.as_tensor(w))
    got = shift_matmul.qmatmul_int8(torch.as_tensor(x), wp, torch.as_tensor(es),
                                    torch.as_tensor(eb), relu=relu)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_holds_int8_gemm_weights_prepared():
    """The CPU Engine of a small W8 ViT holds every dense weight K-major
    (one copy, a view of the param's shape), equal to the artifact's."""
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("vit_b16", seed=0, batch=1, image=32, classes=10, dim=32,
                              depth=1, heads=2, weight_bits=8)
    eng = Engine(art.graph, art.params, device="cpu")
    dense = [n for n in eng.graph.nodes if n.op == "qdense"]
    assert len(dense) == 6  # patch embedding, qkv, proj, mlp1, mlp2, head
    for n in dense:
        w = eng.params[n.params[0]]
        assert shift_matmul.prepared_ld(w) is not None
        assert tuple(w.shape) == tuple(art.params[n.params[0]].shape)
        np.testing.assert_array_equal(w.numpy(), np.asarray(art.params[n.params[0]]))
