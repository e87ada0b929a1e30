"""The stem kernel's launch plan (``tf2_tpu_torch/kernels/qstem.py: plan``),
its prepared weight and the Engine's stem route, on the CPU.

For every zoo stem at batch 64 and 1 and the card tests' ragged stems, a
replay of the kernel's schedule (``csrc/qstem.cu``: the runs, the staging
ring's copied rows, the int8 ring's rows a step reads) shows that every
output row is computed once, every input row is converted from its own
staging slot before the slot is reused, and every step reads the input
rows it needs from the ring; shared memory fits two blocks an SM. The
prepared weight is ``fold_weight``'s rows reordered into (dy, dx, c), each
dy padded to 32 with zeros, seen as the HWIO values. ``Engine.stem_plan``
routes the fused stem of each zoo CNN at reduced depth under the card's
limits, and no stem ``covers`` refuses; the routed stem's weight on the CPU
gives every node the values of the unrouted Engine. Tolerance 0. The
kernel itself is held against ``qstem_plain`` on the card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from tf2_tpu_torch.graph import GraphBuilder, execute
from tf2_tpu_torch.kernels import dispatch, qblocks, qstem
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.runtime.engine import Limits

SMS = 132
CARD = Limits(qlrn_channels=(48 * 1024 - 64) // 6, smem_per_block=qblocks.SMEM_LIMIT)
# (h, w, cin, cout, k, padding): the zoo's stems
ZOO = [(224, 224, 3, 64, 7, "SAME"),     # ResNet-50, GoogLeNet
       (224, 224, 3, 64, 3, "VALID"),    # SqueezeNet v1.1
       (256, 256, 3, 32, 3, "SAME")]     # SSD
# (b, h, w, cin, cout, k, padding): the ragged stems of the card tests and
# chip_smoke.py: k 1-7, odd H and W, cin 1-4, cout 8-130, VALID and SAME
RAGGED = [(3, 37, 41, 1, 16, 5, "SAME"), (3, 33, 19, 2, 24, 5, "VALID"),
          (1, 30, 30, 4, 130, 7, "SAME"), (3, 45, 31, 3, 64, 7, "SAME"),
          (2, 9, 7, 3, 8, 1, "SAME"), (2, 15, 13, 3, 96, 3, "SAME"),
          (2, 17, 21, 2, 32, 3, "VALID"), (2, 11, 11, 4, 256, 5, "SAME"),
          (5, 23, 29, 1, 64, 3, "SAME"), (2, 21, 19, 4, 32, 7, "VALID")]


def _replay(p: qstem.Plan, b: int, h: int, w: int, cin: int, cout: int, k: int, padding):
    """Walk the kernel's schedule for plan ``p``, block by block (a block
    takes runs blockIdx, blockIdx + grid, ...): the producer's staging slots
    and ring rows, both indexed across the block's runs (a staging slot is
    converted before it is reused, so each use of its mbarrier is one
    phase), the rows of step gs converted while the consumer may still read
    step gs - 1; assert what the module docstring says."""
    g = qstem.stem_geometry(h, w, k, k, padding)
    oh, ow = g["oh"], g["ow"]
    lead = max(k - 2, 0)
    assert p.nr == qstem.ring_rows(p.rs, k) and p.nw == (32 if cout <= 32 else 64)
    assert p.nchunks * p.nw >= cout > (p.nchunks - 1) * p.nw
    assert p.half % 128 == 64
    assert p.half >= p.b0 + max((g["pw0"] + w) * cin, 2 * (ow - 1) * cin + qstem.KSTEP)
    assert p.b0 in (2, 4) and ((p.b0 + g["pw0"] * cin) % 4 == 0 or g["pw0"] * cin % 2)
    parts = qstem.smem_bytes(k, p.rs, p.depth, p.srow, p.half, cout, p.nw, p.cvec > 0)
    assert parts == (p.stage_bytes, p.ring_bytes, p.b_bytes, p.smem)
    assert p.stage_bytes % 1024 == 0 and p.ring_bytes % 1024 == 0  # B's tiles 1024-aligned
    assert p.smem <= qstem.SMEM_LIMIT and p.blocks_per_sm * (p.smem + 1024) <= qstem.SMEM_SM
    assert p.grid == min(p.runs, SMS * p.blocks_per_sm)
    assert p.ns * p.srow <= p.stage_bytes
    seen = []
    for block in range(p.grid):
        held, jbase, previous = {}, 0, set()  # ring slot -> stream row; rows step gs - 1 reads
        for run in range(block, p.runs, p.grid):
            img, q = divmod(run, p.runs_per_image)
            oy0 = q * p.run_rows
            rows = min(p.run_rows, oh - oy0)
            assert img < b and rows >= 1
            seen += [(img, oy0 + r) for r in range(rows)]
            nstream = 2 * (rows - 1) + k
            nsteps = -(-rows // p.rs)

            def first(s):
                return 2 * p.rs * s + lead if s else 0

            def last(s, nstream=nstream):
                return min(2 * p.rs * s + 2 * p.rs + k - 3, nstream - 1)

            staged = {}

            def issue(j0, j1, staged=staged, jbase=jbase):
                for j in range(j0, j1 + 1):
                    if p.cvec:
                        slot = (jbase + j) % p.ns
                        assert slot not in staged, "a staging slot reused before its conversion"
                        staged[slot] = jbase + j

            issue(0, k - 3)
            for d in range(p.depth):
                issue(first(d) if d else lead, last(d))
            for s in range(nsteps):
                for j in range(first(s), last(s) + 1):
                    if p.cvec:
                        assert staged.pop((jbase + j) % p.ns) == jbase + j
                    slot = (jbase + j) % p.nr
                    assert held.get(slot) not in previous, "a row the consumer reads overwritten"
                    held[slot] = jbase + j
                issue(first(s + p.depth), last(s + p.depth))
                needed = set()
                for r in range(min(p.rs, rows - p.rs * s)):
                    for dy in range(k):
                        row = jbase + 2 * (p.rs * s + r) + dy
                        assert held[row % p.nr] == row
                        needed.add(row)
                previous = needed
            assert not staged
            jbase += nstream
    assert sorted(seen) == [(i, y) for i in range(b) for y in range(oh)]


@pytest.mark.parametrize("stem", ZOO)
@pytest.mark.parametrize("batch", [64, 1])
def test_plan_on_zoo_stems(stem, batch):
    h, w, cin, cout, k, padding = stem
    p = qstem.plan(batch, h, w, cin, cout, k, padding)
    assert p is not None and p.cvec == 16  # a 224- or 256-pixel f32 row: 16-byte copies
    _replay(p, batch, h, w, cin, cout, k, padding)
    assert p.blocks_per_sm == 2 and p.eff >= 0.86
    if batch == 64:  # one wave: 4 runs an image, of 28 or 32 rows
        assert p.runs == 256 and p.grid == 256
    else:  # one output row a block
        assert p.run_rows == 1 and p.rs == 1


@pytest.mark.parametrize("stem", RAGGED)
@pytest.mark.parametrize("f32", [True, False])
def test_plan_on_ragged_stems(stem, f32):
    b, h, w, cin, cout, k, padding = stem
    p = qstem.plan(b, h, w, cin, cout, k, padding, f32)
    assert p is not None
    _replay(p, b, h, w, cin, cout, k, padding)
    row_bytes = w * cin * (4 if f32 else 1)
    assert p.cvec == (16 if row_bytes % 16 == 0 else 4 if row_bytes % 4 == 0 else 0)


@pytest.mark.parametrize("rs,depth", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2)])
def test_given_steps_replay(rs, depth):
    """Every step a sweep may give (bench/qstem_ab.py --plans)."""
    for h, w, cin, cout, k, padding in ZOO:
        p = qstem.plan(64, h, w, cin, cout, k, padding, rs=rs, depth=depth)
        assert (p.rs, p.depth) == (rs, depth)
        _replay(p, 64, h, w, cin, cout, k, padding)


def test_plan_tail_and_refusals():
    """A row that is not a multiple of 16 bytes takes 4-byte copies (f32)
    or is read in the conversion (int8 rows of odd length) or at an
    unaligned image; k 9, cout 257 and a block too large are refused."""
    assert qstem.plan(2, 41, 41, 1, 16, 5, "SAME").cvec == 4             # 164-byte rows
    assert qstem.plan(2, 41, 41, 1, 16, 5, "SAME", False).cvec == 0      # 41-byte rows
    assert qstem.plan(2, 40, 40, 4, 16, 5, "SAME", True, 8).cvec == 4    # image 8-byte aligned
    assert qstem.plan(2, 64, 64, 3, 32, 9, "SAME") is None
    assert qstem.plan(2, 64, 64, 3, 257, 7, "SAME") is None
    assert qstem.plan(1, 224, 224, 3, 64, 7, "SAME", smem_limit=20000) is None
    assert qstem.plan(1, 224, 224, 3, 64, 7, "SAME", smem_limit=96 * 1024) is not None


@pytest.mark.parametrize("k,cin,cout", [(7, 3, 64), (3, 3, 32), (5, 4, 130), (1, 1, 8),
                                        (7, 4, 16), (3, 2, 96)])
def test_prepared_weight_is_fold_weight_reordered(k, cin, cout):
    rng = np.random.default_rng(k * cin + cout)
    w = torch.as_tensor(rng.integers(-128, 128, (k, k, cin, cout), dtype=np.int8))
    wp = qstem.prepare_weight(w)
    assert tuple(wp.shape) == (k, k, cin, cout) and torch.equal(wp, w)
    assert qstem.prepared_ld(wp) == k * qstem.KSTEP
    assert qstem.prepared_ld(w) is None and qstem.prepared_ld(wp.contiguous()) is None
    rows = torch.as_strided(wp, (cout, k, qstem.KSTEP), (k * qstem.KSTEP, qstem.KSTEP, 1))
    taps = rows[:, :, :k * cin].reshape(cout, k, k, cin)          # (n, dy, dx, c)
    folded = qstem.fold_weight(w)[:cin * k * k].reshape(cin, k, k, cout)  # (c, dy, dx, n)
    assert torch.equal(taps, folded.permute(3, 1, 2, 0))
    assert not rows[:, :, k * cin:].any()
    with pytest.raises(ValueError, match="taps a row"):
        qstem.prepare_weight(torch.zeros((9, 9, 4, 8), dtype=torch.int8))


@pytest.mark.parametrize("name,image,kw", [
    ("resnet50", 64, dict(depths=(1, 1, 1, 1))), ("googlenet", 64, {}),
    ("squeezenet_v1_1", 64, {}), ("ssd", 128, {})])
def test_engine_routes_each_zoo_stem(name, image, kw):
    """Under the card's limits ``Engine.stem_plan`` names the model's fused
    stem, and only it; the CPU Engine routes none; the stem's weight in the
    kernel's layout leaves every node's value as it was (on the CPU the
    routed node takes ``fused_qstem``'s plain path)."""
    from tf2_tpu_torch.models import synthetic_quantized

    art = synthetic_quantized(name, seed=0, batch=2, image=image,
                              classes=21 if name == "ssd" else 10, **kw)
    eng = Engine(art.graph, art.params, device="cpu")
    stems = [n.name for n in eng.graph.nodes if n.op == "qconv2d" and "s_in" in n.attrs]
    assert len(stems) == 1 and eng.stem_nodes == frozenset()
    assert Engine.stem_plan(eng.graph, eng.params, CARD) == set(stems)
    routed = dispatch.prepare_weights(eng.graph, eng.params, frozenset(stems))
    w = routed[eng.graph.node_map()[stems[0]].params[0]]
    assert qstem.prepared_ld(w) is not None
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, image, image, 3),
                                                                 dtype=np.float32))
    _, got = execute(eng.graph, intermediates=True)(routed, image=x)
    _, want = execute(eng.graph, intermediates=True)(eng.params, image=x)
    for n in eng.graph.nodes:
        assert torch.equal(got[n.name], want[n.name]), n.name


def _stem_graph(cin, k, strides):
    """A small CNN whose stem is a k x k conv on a cin-channel image at
    ``strides``, quantized as the zoo is (models.synthetic_quantized)."""
    from tf2_tpu_torch.graph.init_params import init_params
    from tf2_tpu_torch.models import SYNTHETIC_ACT_SCALE
    from tf2_tpu_torch.transform import QuantSpec, fold_batch_norm, quantize_graph

    b = GraphBuilder("stem_case")
    x = b.input("image", (2, 32, 32, cin))
    x = b.relu(b.conv2d(x, cin, 16, k, stride=strides, padding="SAME", name="stem_conv"),
               name="stem")
    x = b.relu(b.conv2d(x, 16, 32, 3, stride=2, padding="SAME", name="c2_conv"), name="c2")
    g = b.build(b.dense(b.global_avgpool(x, name="gap"), 32, 10, name="head"), family="cnn")
    fg, fp = fold_batch_norm(g, init_params(g, seed=0))
    scales = dict.fromkeys(list(fg.inputs) + [n.name for n in fg.nodes], SYNTHETIC_ACT_SCALE)
    return quantize_graph(fg, fp, scales, QuantSpec(weight_bits=8))


@pytest.mark.parametrize("cin,k,strides,routed", [
    (3, 3, 2, True), (4, 5, 2, True),           # taken
    (5, 3, 2, False),                          # cin 5: no fused quantize, no qstem
    (3, 4, 2, False),                          # an even k: covers refuses
    (3, 3, (2, 1), False)])                    # strides (2, 1): covers refuses
def test_engine_stem_plan_follows_covers(cin, k, strides, routed):
    art = _stem_graph(cin, k, strides)
    eng = Engine(art.graph, art.params, device="cpu")
    stem = next(n for n in eng.graph.nodes if n.op == "qconv2d")
    assert ("s_in" in stem.attrs) == (cin <= 4)  # else an eager quantize node before it
    assert Engine.stem_plan(eng.graph, eng.params, CARD) == ({stem.name} if routed else set())
    if routed:  # a card whose blocks hold too little shared memory routes none
        assert Engine.stem_plan(eng.graph, eng.params, Limits(CARD.qlrn_channels, 512)) \
            == frozenset()
