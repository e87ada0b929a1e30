"""The port's fused bottleneck-chain path against tf2_tpu's, on the CPU:
the plain chain against ``reference_chain`` (and the Pallas kernel in
interpret mode), the ``fuse_bottleneck_chains`` pass and ``activation_shapes``
against the reference's, and ``Engine(block_fusion=True)`` on a small ResNet
(batch 2, image 64, depths (2,2,2,2)) against tf2_tpu's block-fused Engine,
node by node. Tolerance 0 throughout. The chain kernel itself is held
against the plain chain on the card in tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.optimize import fuse_bottleneck_chains as ref_fuse_bottleneck_chains
from tf2_tpu.graph.shapes import activation_shapes as ref_activation_shapes
from tf2_tpu.kernels import qblocks as ref_qblocks
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.runtime.engine import _predecode_fallback_weights as ref_predecode
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch import kernels
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.graph.optimize import fuse_bottleneck_chains
from tf2_tpu_torch.graph.shapes import activation_shapes
from tf2_tpu_torch.kernels import qblocks
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import from_reference

SMALL = dict(batch=2, image=64, depths=(2, 2, 2, 2), classes=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside multi-process JAX tests;
    one intra-op thread keeps these float64 checks from starving them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk_block(rng, cin, cm, cout, down=False, relu=True):
    """The block generator of tests/kernels/test_qblocks.py."""
    b = {
        "w1": rng.integers(-127, 128, (cin, cm), dtype=np.int8),
        "es1": rng.uniform(1e-4, 5e-3, cm).astype(np.float32),
        "eb1": (rng.normal(size=cm) * 0.3).astype(np.float32),
        "w2": rng.integers(-127, 128, (3, 3, cm, cm), dtype=np.int8),
        "es2": rng.uniform(1e-4, 5e-4, cm).astype(np.float32),
        "eb2": (rng.normal(size=cm) * 0.3).astype(np.float32),
        "w3": rng.integers(-127, 128, (cm, cout), dtype=np.int8),
        "es3": rng.uniform(1e-4, 5e-4, cout).astype(np.float32),
        "eb3": (rng.normal(size=cout) * 0.3).astype(np.float32),
        "sa_over_so": float(rng.uniform(0.5, 1.5)),
        "sb_over_so": float(rng.uniform(0.5, 1.5)),
        "relu": relu,
    }
    if down:
        b["wd"] = rng.integers(-127, 128, (cin, cout), dtype=np.int8)
        b["esd"] = rng.uniform(1e-4, 5e-4, cout).astype(np.float32)
        b["ebd"] = (rng.normal(size=cout) * 0.3).astype(np.float32)
    return b


def _torch_blocks(blocks):
    return [{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
            for b in blocks]


def _chain_case(nblocks, down):
    """The cases of tests/kernels/test_qblocks.py::test_chain_parity."""
    rng = np.random.default_rng(nblocks + 10 * down)
    blocks = [_mk_block(rng, 32, 8, 32, down=(down and i == 0)) for i in range(nblocks)]
    return rng.integers(-127, 128, (2, 16, 16, 32), dtype=np.int8), blocks


def _extremes_case():
    """test_qblocks.py::test_chain_parity_adversarial_extremes: +-127."""
    rng = np.random.default_rng(99)
    blocks = [_mk_block(rng, 16, 8, 16)]
    x = np.full((1, 8, 8, 16), 127, dtype=np.int8)
    x[0, :2] = -127
    return x, blocks


@pytest.mark.parametrize("case", ["1", "2", "3", "2down", "extremes"])
def test_plain_chain_matches_reference_chain(case):
    x, blocks = (_extremes_case() if case == "extremes"
                 else _chain_case(int(case[0]), case.endswith("down")))
    want = np.asarray(ref_qblocks.reference_chain(jnp.asarray(x), blocks))
    kernels.reset_launch_counts()
    got = qblocks.qblockchain(torch.as_tensor(x), _torch_blocks(blocks))
    assert got.dtype == torch.int8 and got.shape == x.shape[:3] + (blocks[-1]["w3"].shape[1],)
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernels.launch_counts()["qblockchain"] == 0  # the CPU takes the plain chain


def test_plain_chain_matches_pallas_kernel():
    """Through ``fused_qblockchain(plain=True)``, against the reference's
    ``reference_chain`` jitted, as its executor runs it off the TPU (what
    tests/kernels/test_qblocks.py holds the Pallas kernel against; no
    Pallas interpret mode, which can deadlock)."""
    x, blocks = _chain_case(2, True)
    want = jax.jit(lambda v: ref_qblocks.reference_chain(v, blocks))(jnp.asarray(x))
    got = qblocks.fused_qblockchain(torch.as_tensor(x), _torch_blocks(blocks), plain=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_coverage_and_band_rows():
    """The chain kernel's shared-memory rule (not the TPU's VMEM rule): every
    ResNet-50 block shape at batch 64 and 1 has a launch plan (whole images
    or bands a cluster) whose shared memory fits; a chain whose smallest
    piece overflows, an identity block that changes the channel count, or a
    block that does not read its predecessor's output is refused."""
    rng = np.random.default_rng(0)
    stage4 = [_mk_block(rng, 2048, 512, 2048) for _ in range(2)]
    assert qblocks.covers((1, 7, 7, 2048), stage4)
    for b in (64, 1):
        for h, cin, cm, cout, down in [(56, 64, 64, 256, True), (56, 256, 64, 256, False),
                                       (28, 512, 128, 512, False), (14, 1024, 256, 1024, False),
                                       (7, 2048, 512, 2048, False)]:
            p = qblocks.plan(b, h, h, cin, cm, cout, down, sms=132, max_cluster=16)
            assert p.smem == qblocks.smem_bytes(h, h, cm, p.g, p.r, p.wc, p.bn)
            assert p.smem <= qblocks.SMEM_LIMIT and p.c <= 16
    # the ragged chains of the card tests and chip_smoke.py
    for b, h, w, cm in [(64, 9, 13, 40), (96, 12, 12, 32), (3, 8, 8, 16), (1, 7, 7, 512)]:
        assert qblocks.plan(b, h, w, 64, cm, 64, True).smem <= qblocks.SMEM_LIMIT
    # a wide image takes bands narrower than a row
    assert qblocks.covers((1, 300, 300, 64), [_mk_block(rng, 64, 256, 64)])
    assert not qblocks.plan(1, 300, 300, 64, 256, 64, False).whole
    huge = {"w1": np.empty((64, 16384), np.int8), "w3": np.empty((16384, 64), np.int8)}
    assert not qblocks.covers((1, 8, 8, 64), [huge])
    assert not qblocks.covers((1, 8, 8, 32), [_mk_block(rng, 32, 8, 64)])
    assert not qblocks.covers((1, 8, 8, 16), [_mk_block(rng, 32, 8, 32)])


def _ref_artifact(depths, calibrated=False):
    g = ref_get_model("resnet50", batch=2, image=64, classes=64, depths=depths)
    fg, fp = ref_fold(g, {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()})
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    if calibrated:
        scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    else:
        scales = dict.fromkeys(fg.inputs, 0.02)
        scales.update(dict.fromkeys((n.name for n in fg.nodes), 0.02))
    return ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=4, pot_candidates=5)), x


@pytest.mark.parametrize("depths", [(1, 1, 1, 1), (2, 1, 1, 1), (2, 2, 2, 2)])
def test_fuse_bottleneck_chains_matches_reference(depths):
    """On fully int8-decoded graphs (the reference's predecode off-TPU)
    both passes emit the same graph JSON, and the shapes they read agree."""
    art, _ = _ref_artifact(depths)
    g0, p0 = ref_predecode(art.graph, art.params)
    ref_g, _ = ref_fuse_bottleneck_chains(g0, p0)
    g, p = from_reference(g0.to_json(), p0)
    port_g, _ = fuse_bottleneck_chains(g, p)
    assert port_g.to_json() == ref_g.to_json()
    chains = [n for n in port_g.nodes if n.op == "qblockchain"]
    assert [len(n.attrs["blocks"]) for n in chains] == [depths[0]] + [d - 1 for d in depths[1:]
                                                                      if d > 1]


def test_activation_shapes_match_reference():
    art, _ = _ref_artifact((2, 2, 2, 2))
    g, p = from_reference(art.graph.to_json(), art.params)
    want = ref_activation_shapes(art.graph, art.params)
    got = activation_shapes(g, p)
    assert got == want and len(got) == len(g.nodes) + len(g.inputs)


@pytest.fixture(scope="module")
def fused_case():
    art, x = _ref_artifact(SMALL["depths"], calibrated=True)
    ref_logits = np.asarray(RefEngine(art.graph, art.params, block_fusion=True).run(image=x))
    unpacked = RefEngine(art.graph, art.params, block_fusion=True, phase_stem=False)
    _, env = jax.jit(ref_execute(unpacked.graph, intermediates=True))(
        unpacked.params, image=jnp.asarray(x))
    g, p = from_reference(art.graph.to_json(), art.params)
    return dict(g=g, p=p, x=x, ref_logits=ref_logits, ref_graph=unpacked.graph,
                ref_env={k: np.asarray(v) for k, v in env.items()},
                fused=Engine(g, p, device="cpu", block_fusion=True))


def test_fused_engine_logits_equal_reference(fused_case):
    kernels.reset_launch_counts()
    y = fused_case["fused"].run(image=fused_case["x"])
    np.testing.assert_array_equal(y.numpy(), fused_case["ref_logits"])
    assert set(kernels.launch_counts().values()) == {0}


def test_fused_engine_every_int8_node_equals_reference(fused_case):
    """Every int8 value of the port's fused graph, the chain nodes
    included, equals the reference's fused graph (without its stem
    rewrite) at the node of the same name."""
    eng = fused_case["fused"]
    _, env = execute(eng.graph, intermediates=True)(eng.params,
                                                    image=torch.as_tensor(fused_case["x"]))
    int8_nodes = [n.name for n in eng.graph.nodes if env[n.name].dtype == torch.int8]
    assert len(int8_nodes) == 23
    assert [n.name for n in eng.graph.nodes if n.op == "qblockchain"] == [
        n.name for n in fused_case["ref_graph"].nodes if n.op == "qblockchain"]
    for name in int8_nodes:
        np.testing.assert_array_equal(env[name].numpy(), fused_case["ref_env"][name],
                                      err_msg=name)


def test_fused_engine_equals_unfused(fused_case):
    x = fused_case["x"]
    unfused = Engine(fused_case["g"], fused_case["p"], device="cpu")
    assert torch.equal(fused_case["fused"].run(image=x), unfused.run(image=x))


def test_fused_graph_decodes_only_chain_convs(fused_case):
    """4 chains (2, 1, 1, 1 blocks) whose convs carry int8 ``.wq``
    weights; every conv outside a chain keeps what the unfused Engine gives
    it (packed pot4, the int8 stem)."""
    fused = fused_case["fused"]
    unfused = Engine(fused_case["g"], fused_case["p"], device="cpu")
    chains = [n for n in fused.graph.nodes if n.op == "qblockchain"]
    assert [len(n.attrs["blocks"]) for n in chains] == [2, 1, 1, 1]
    assert [(n.attrs["h"], n.attrs["w"]) for n in chains] == [(16, 16), (8, 8), (4, 4), (2, 2)]
    for n in chains:
        weights = n.params[0::3]
        assert all(w.endswith(".wq") and fused.params[w].dtype == torch.int8 for w in weights)
        assert len(weights) == sum(4 if b["down"] else 3 for b in n.attrs["blocks"])
    by_name = unfused.graph.node_map()
    outside = [n for n in fused.graph.nodes if n.op == "qconv2d"]
    assert len(outside) == 13
    for n in outside:
        assert n.to_json() == by_name[n.name].to_json()
    assert [n.attrs["wfmt"] for n in outside].count("pot4") == 12
