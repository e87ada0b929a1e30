"""The chain kernel's launch plan (``tf2_tpu_torch/kernels/qblocks.py:
plan``) and its K-major weights, on the CPU. For each block of ResNet-50's
four chains at batch 64 and 1 and for ragged chains, a replay of the
plan's partition (``qblocks.pieces``, the kernel's own index arithmetic)
shows that every (pixel, output channel) of the 3x3, of c3 and of the
downsample is computed by exactly one CTA, and every c1 value a cluster's
3x3 reads exactly once in that cluster (whole images: exactly once
overall); shared memory fits and clusters stay within 16 CTAs (8 unless
asked). Every chain the previous kernel's ``covers`` took is still taken.
``prepare_w2`` gives the original weights, and the plain chain on prepared
weights equals the reference's ``reference_chain`` (``tf2_tpu/kernels/
qblocks.py:282``, what tests/kernels/test_qblocks.py holds its Pallas
kernel against), eager and jitted; no Pallas interpret mode. Tolerance 0. The kernel itself is
held against the plain chain on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.kernels import qblocks as ref_qblocks
from tf2_tpu_torch.kernels import qblocks, shift_matmul

SMS = 132
# ResNet-50's fused blocks (h, cin, cm, cout, down): the four chains
RESNET_BLOCKS = [(56, 64, 64, 256, True), (56, 256, 64, 256, False),
                 (28, 512, 128, 512, False), (14, 1024, 256, 1024, False),
                 (7, 2048, 512, 2048, False)]
# (b, h, w, cin, cm, cout, down): the ragged chains of the card tests and
# chip_smoke.py
RAGGED = [(64, 9, 13, 48, 40, 64, True), (64, 9, 13, 64, 40, 64, False),
          (96, 12, 12, 32, 32, 96, True), (3, 8, 8, 64, 16, 64, False),
          (1, 7, 7, 2048, 512, 2048, False), (1, 300, 300, 64, 256, 64, False),
          (2, 6, 6, 40, 16, 40, False), (5, 7, 7, 512, 512, 512, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _replay(p, b, h, w, cm, cout):
    """Counts, per (image, row, column) and channel, the CTAs that compute
    each conv's output, and checks that each c1 value a cluster reads is
    computed once in that cluster."""
    out3 = np.zeros((b, h, w, cm), np.int32)    # the 3x3
    outc = np.zeros((b, h, w, cout), np.int32)  # c3 and the downsample
    c1 = np.zeros((b, h, w, cm), np.int32)
    clusters = {}
    for cta, (imgs, rows, cols, c1rows, c1cols, ms, os_) in enumerate(
            qblocks.pieces(p, b, h, w, cm, cout)):
        assert len(imgs) and len(rows) and len(cols) and len(ms) and len(os_)
        sl = (slice(imgs.start, imgs.stop), slice(rows.start, rows.stop),
              slice(cols.start, cols.stop))
        out3[sl + (slice(ms.start, ms.stop),)] += 1
        outc[sl + (slice(os_.start, os_.stop),)] += 1
        c1[(sl[0], slice(c1rows.start, c1rows.stop), slice(c1cols.start, c1cols.stop),
            slice(ms.start, ms.stop))] += 1
        clusters.setdefault(cta // p.c, []).append((imgs, rows, cols, c1rows, c1cols, ms))
    assert (out3 == 1).all() and (outc == 1).all()
    for members in clusters.values():
        imgs, rows, cols, c1rows, c1cols, _ = members[0]
        # the cluster's CTAs share the piece and split the channels
        assert all(m[:5] == members[0][:5] for m in members)
        got = sorted(ch for m in members for ch in m[5])
        assert got == list(range(cm))
        # the halo: exactly the pixels the 3x3 reads, inside the image
        assert c1rows == range(max(rows.start - 1, 0), min(rows.stop + 1, h))
        assert c1cols == range(max(cols.start - 1, 0), min(cols.stop + 1, w))
    if p.whole:
        assert (c1 == 1).all()
    else:
        assert (c1 >= 1).all()
    return out3


def _check(p, b, h, w, cm, cout, max_cluster=16):
    assert p is not None
    assert p.smem == qblocks.smem_bytes(h, w, cm, p.g, p.r, p.wc, p.bn) <= qblocks.SMEM_LIMIT
    assert 1 <= p.c <= max_cluster and p.bn in (32, 64)
    assert p.c == 1 or (cm % (16 * p.c) == 0 and cout % (16 * p.c) == 0)
    assert p.g == 1 or p.whole
    assert p.whole == (p.r == h and p.wc == w)
    assert p.ctas == -(-b // p.g) * -(-h // p.r) * -(-w // p.wc) * p.c
    _replay(p, b, h, w, cm, cout)


@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("block", RESNET_BLOCKS, ids=str)
@pytest.mark.parametrize("max_cluster", [8, 16])
def test_resnet50_plans_partition_every_output_once(batch, block, max_cluster):
    h, cin, cm, cout, down = block
    p = qblocks.plan(batch, h, h, cin, cm, cout, down, SMS, max_cluster)
    _check(p, batch, h, h, cm, cout, max_cluster)


@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_ragged_plans_partition_every_output_once(case):
    b, h, w, cin, cm, cout, down = case
    p = qblocks.plan(b, h, w, cin, cm, cout, down, SMS, 16)
    _check(p, b, h, w, cm, cout)


# the explicit plans of the card tests: every kind the kernel takes
@pytest.mark.parametrize("case,plan", [
    ((2, 9, 13, 64, 64), (1, 2, 13, 1, 64)), ((2, 9, 13, 40, 64), (1, 3, 13, 1, 32)),
    ((1, 12, 30, 32, 32), (1, 1, 7, 1, 32)), ((2, 14, 14, 64, 128), (1, 4, 14, 2, 32)),
    ((3, 7, 7, 256, 256), (1, 7, 7, 4, 64)), ((5, 7, 7, 512, 512), (2, 7, 7, 8, 64)),
    ((4, 8, 8, 32, 64), (3, 8, 8, 1, 32)), ((1, 7, 7, 512, 512), (1, 7, 7, 16, 32)),
    ((2, 6, 6, 16, 40), (1, 6, 6, 1, 32))], ids=str)
def test_given_plans_partition_every_output_once(case, plan):
    b, h, w, cm, cout = case
    _check(qblocks.make_plan(b, h, w, cm, *plan), b, h, w, cm, cout)


def _parent_smem(h, w, cm, band):
    """The previous chain kernel's shared memory at a band of ``band`` rows
    (its covers asked for one row): c1's band with a halo row and a zero
    column each side, the 3x3's band, pixel rows of round_up(Cm, 32) + 16
    bytes, and two staged 64 x 80 byte tiles."""
    ps = -(-cm // 32) * 32 + 16
    return (band + 2) * (w + 2) * ps + band * w * ps + 2 * 64 * 80


@pytest.mark.parametrize("cm", [16, 40, 64, 128, 256, 512, 1024, 2048, 4096])
def test_covers_takes_every_chain_the_parent_took(cm):
    for h, w in [(1, 1), (7, 7), (14, 14), (56, 56), (9, 13), (300, 300), (2, 700),
                 (1, 1000), (5, 60)]:
        for cout in (cm, 4 * cm):
            blk = {"w1": np.empty((cout, cm), np.int8), "w3": np.empty((cm, cout), np.int8)}
            if _parent_smem(h, w, cm, 1) > qblocks.SMEM_LIMIT:
                continue
            assert qblocks.covers((2, h, w, cout), [blk]), (h, w, cm, cout)
            p = qblocks.plan(2, h, w, cout, cm, cout, False)
            assert p.smem <= qblocks.SMEM_LIMIT


@pytest.mark.parametrize("cm", [16, 40, 64, 256])
def test_prepare_w2_is_the_original(cm):
    w2 = torch.as_tensor(np.random.default_rng(cm).integers(-127, 128, (3, 3, cm, cm),
                                                             dtype=np.int8))
    wp = qblocks.prepare_w2(w2)
    cmp = -(-cm // 16) * 16
    assert torch.equal(wp, w2) and qblocks.w2_ld(wp) == 9 * cmp
    rows = torch.as_strided(wp, (cm, 9, cmp), (9 * cmp, cmp, 1))
    for tap in range(9):
        assert torch.equal(rows[:, tap, :cm], w2[tap // 3, tap % 3].t())
    assert not rows[:, :, cm:].any()
    assert qblocks.w2_ld(w2) is None


def _mk_block(rng, cin, cm, cout, down=False, relu=True):
    """The block generator of tests/kernels/test_qblocks.py."""
    b = {"w1": rng.integers(-127, 128, (cin, cm), dtype=np.int8),
         "es1": rng.uniform(1e-4, 5e-3, cm).astype(np.float32),
         "eb1": (rng.normal(size=cm) * 0.3).astype(np.float32),
         "w2": rng.integers(-127, 128, (3, 3, cm, cm), dtype=np.int8),
         "es2": rng.uniform(1e-4, 5e-4, cm).astype(np.float32),
         "eb2": (rng.normal(size=cm) * 0.3).astype(np.float32),
         "w3": rng.integers(-127, 128, (cm, cout), dtype=np.int8),
         "es3": rng.uniform(1e-4, 5e-4, cout).astype(np.float32),
         "eb3": (rng.normal(size=cout) * 0.3).astype(np.float32),
         "sa_over_so": float(rng.uniform(0.5, 1.5)),
         "sb_over_so": float(rng.uniform(0.5, 1.5)), "relu": relu}
    if down:
        b["wd"] = rng.integers(-127, 128, (cin, cout), dtype=np.int8)
        b["esd"] = rng.uniform(1e-4, 5e-4, cout).astype(np.float32)
        b["ebd"] = (rng.normal(size=cout) * 0.3).astype(np.float32)
    return b


def _prepared(blocks):
    out = []
    for blk in blocks:
        t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in blk.items()}
        for k in ("w1", "w3", "wd"):
            if k in t:
                t[k] = shift_matmul.prepare_weight(t[k])
        t["w2"] = qblocks.prepare_w2(t["w2"])
        out.append(t)
    return out


@pytest.mark.parametrize("nblocks,down,cm", [(1, False, 8), (2, True, 8), (2, False, 40)])
def test_plain_chain_on_prepared_weights_matches_reference(nblocks, down, cm):
    rng = np.random.default_rng(nblocks + 10 * down + cm)
    blocks = [_mk_block(rng, 32, cm, 32, down=(down and i == 0)) for i in range(nblocks)]
    x = rng.integers(-127, 128, (2, 12, 12, 32), dtype=np.int8)
    want = np.asarray(ref_qblocks.reference_chain(jnp.asarray(x), blocks))
    prepared = _prepared(blocks)
    assert all(shift_matmul.prepared_ld(b["w1"]) is not None and qblocks.w2_ld(b["w2"])
               for b in prepared)
    got = qblocks.qblockchain(torch.as_tensor(x), prepared)
    np.testing.assert_array_equal(got.numpy(), want)
    if cm == 8:  # and jitted, as the reference's executor runs it off the TPU
        jitted = jax.jit(lambda v: ref_qblocks.reference_chain(v, blocks))(jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jitted))


def test_engine_holds_chain_weights_prepared():
    """The block-fused CPU Engine holds every chain weight K-major (one
    copy, a view of the param's shape), equal to the unfused values."""
    from tf2_tpu_torch.kernels import dispatch
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("resnet50", seed=0, batch=1, image=64, depths=(2, 1, 1, 1),
                              classes=16)
    eng = Engine(art.graph, art.params, device="cpu", block_fusion=True)
    chains = [n for n in eng.graph.nodes if n.op == "qblockchain"]
    assert len(chains) == 1
    blocks = dispatch.chain_blocks(chains[0], eng.params)
    assert len(blocks) == 2 and "wd" in blocks[0]
    for blk in blocks:
        assert qblocks.w2_ld(blk["w2"]) is not None
        assert all(shift_matmul.prepared_ld(blk[k]) is not None
                   for k in ("w1", "w3", "wd") if k in blk)
    plain = Engine(art.graph, art.params, device="cpu")
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(np.float32)
    assert torch.equal(eng.run(image=x), plain.run(image=x))
