"""The Engine as the reference runs it, on the CPU against tf2_tpu: ``build``
(on the CPU the warm-up forward alone), ``donate_inputs`` (the port of
tests/test_engine_donation.py's ``test_donated_engine_matches_nondonated``
on the parity harness's small artifact), ``predecode=False`` (every int8
node against the reference Engine with the same flag), and the stems the
stem kernel's plan has no launch for (k 9, cout 288) through
``fused_qstem`` and an Engine. Tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.ir import Graph as RefGraph
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch.bench import coverage_cases
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.kernels import qstem
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import from_reference

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    """The parity harness's artifact: the reference's ResNet at SMALL,
    calibrated on one seeded batch, W4-PoT."""
    g = ref_get_model("resnet50", **SMALL)
    fg, fp = ref_fold(g, {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()})
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    art = ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=4, pot_candidates=5))
    ref_logits = np.asarray(RefEngine(art.graph, art.params, phase_stem=False).run(image=x))
    return dict(art=art, x=x, ref_logits=ref_logits)


def _port(case, **flags):
    """The port's Engine on the harness's artifact, unfused unless
    ``flags`` say (the reference's default)."""
    g, p = from_reference(case["art"].graph.to_json(), case["art"].params)
    return Engine(g, p, device="cpu", **{"block_fusion": False, **flags})


def test_build_on_the_cpu_is_the_eager_forward(case):
    """``build`` warms up and captures nothing on the CPU; the forward
    after it equals the reference Engine's, twice over."""
    eng = _port(case)
    assert eng.build(image=case["x"]) is eng and not eng.built
    for _ in range(2):
        np.testing.assert_array_equal(eng.run(image=case["x"]).numpy(), case["ref_logits"])
    assert not _port(case).build().built  # zero inputs


def test_donated_engine_matches_nondonated(case):
    """The port's donated Engine against the reference's Engine, a fresh
    batch each call (the serving pattern donation asks for): equal
    outputs; each donated tensor's storage is freed after its call, and a
    numpy batch (which torch does not own) is read and kept."""
    eng = _port(case, donate_inputs=True)
    for _ in range(3):
        x = torch.as_tensor(case["x"]).clone()
        np.testing.assert_array_equal(eng.run(image=x).numpy(), case["ref_logits"])
        assert x.untyped_storage().nbytes() == 0
    x = case["x"].copy()
    np.testing.assert_array_equal(eng.run(image=x).numpy(), case["ref_logits"])
    np.testing.assert_array_equal(x, case["x"])
    undonated = torch.as_tensor(case["x"]).clone()
    np.testing.assert_array_equal(_port(case).run(image=undonated).numpy(), case["ref_logits"])
    assert undonated.untyped_storage().nbytes() == undonated.numel() * 4


def test_donation_keeps_an_input_an_output_shares():
    """An output that is a view of the donated input keeps its storage."""
    from tf2_tpu_torch.graph import GraphBuilder

    b = GraphBuilder("passthrough")
    g = b.build(b.reshape(b.input("image", (2, 4)), (2, 2, 2), name="view"), family="cnn")
    eng = Engine(g, {}, device="cpu", donate_inputs=True)
    t = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    out = eng.run(image=t)
    assert out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    assert torch.equal(out, torch.arange(8, dtype=torch.float32).reshape(2, 2, 2))


@pytest.mark.parametrize("flags", [{}, {"block_fusion": True}, {"optimize": True}],
                         ids=["plain", "block_fusion", "optimize"])
def test_predecode_false_every_int8_node_equals_reference(case, flags):
    """``predecode=False`` in both packages: no decode and no load pass of
    the predecode block, ``block_fusion`` and ``optimize`` still applied;
    the same graph, every int8 node and the logits equal."""
    art, x = case["art"], case["x"]
    ref = RefEngine(art.graph, art.params, predecode=False, **flags)
    _, ref_env = jax.jit(ref_execute(ref.graph, intermediates=True))(ref.params,
                                                                     image=jnp.asarray(x))
    eng = _port(case, predecode=False, **flags)
    assert eng.graph.to_json() == ref.graph.to_json()
    assert eng.routes == {} and eng.library_nodes == frozenset()
    out, env = execute(eng.graph, intermediates=True)(eng.params, image=torch.as_tensor(x))
    int8 = [n.name for n in eng.graph.nodes if env[n.name].dtype == torch.int8]
    assert len(int8) >= 20
    for name in int8:
        np.testing.assert_array_equal(env[name].numpy(), np.asarray(ref_env[name]), err_msg=name)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_env[ref.graph.outputs[0]]))
    assert sum(n.attrs.get("wfmt") == "pot4" for n in eng.graph.nodes) > 0


def test_predecode_false_keeps_the_quantize_and_the_stem_apart(case):
    eng = _port(case, predecode=False, phase_stem=True, merge_1x1=True)
    ops = [n.op for n in eng.graph.nodes]
    assert ops[0] == "quantize" and "s_in" not in eng.graph.nodes[1].attrs
    assert all(n.attrs.get("wfmt") != "wpack2" for n in eng.graph.nodes)
    np.testing.assert_array_equal(eng.run(image=case["x"]).numpy(), case["ref_logits"])


def _ref_stem(x_q, w_q, es, eb, relu, padding):
    """tests/kernels/test_qstem.py's reference: int32 lax conv + epilogue."""
    acc = lax.conv_general_dilated(jnp.asarray(x_q), jnp.asarray(w_q), (2, 2), padding,
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(es) + jnp.asarray(eb)
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))


@pytest.mark.parametrize("k,cout", coverage_cases.WIDE_STEMS)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_wide_stems_match_reference(k, cout, padding):
    """Stems ``covers`` takes and the kernel's plan has no launch for (on
    the card they take the quantize and the stride-2 conv kernel):
    ``fused_qstem`` equals the reference test's int32 conv, on int8 and on
    f32 images."""
    assert qstem.covers((k, k, 3, cout), (2, 2), padding, 1, (2, 33, 33, 3))
    assert qstem.plan(2, 33, 33, 3, cout, k, padding) is None
    rng = np.random.default_rng(k + cout)
    x = rng.normal(size=(2, 33, 33, 3)).astype(np.float32)
    w_q = rng.integers(-127, 128, (k, k, 3, cout), dtype=np.int8)
    es = rng.uniform(1e-4, 5e-3, cout).astype(np.float32)
    eb = (rng.normal(size=cout) * 0.1).astype(np.float32)
    x_q = np.clip(np.round(x / np.float32(0.02)), -127, 127).astype(np.int8)
    want = _ref_stem(x_q, w_q, es, eb, True, padding)
    got = qstem.fused_qstem(torch.as_tensor(x_q), torch.as_tensor(w_q), es, eb,
                            padding=padding, relu=True)
    np.testing.assert_array_equal(got.numpy(), want)
    got = qstem.fused_qstem(torch.as_tensor(x), w_q, es, eb, padding=padding, relu=True,
                            scale=0.02)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,cout", coverage_cases.WIDE_STEMS)
def test_wide_stem_engine_matches_reference(k, cout):
    """``coverage_cases.stem_artifact`` through the port's Engine and the
    reference's (its stem as a stride-2 conv, ``phase_stem=False``): the
    stem and the pointwise conv equal. After them comes ``global_avgpool``,
    a chosen divergence (a float64 sum, ROADMAP Queue 3) that may move its
    quantize by one quantum at a rounding boundary (1 of 64 here at cout
    288), so the port's logits are held against its own plain path."""
    art = coverage_cases.stem_artifact(k, cout)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    rg = RefGraph.from_json(art.graph.to_json())
    ref = RefEngine(rg, {kk: np.asarray(v) for kk, v in art.params.items()}, phase_stem=False)
    _, ref_env = jax.jit(ref_execute(ref.graph, intermediates=True))(
        ref.params, image=jnp.asarray(x))
    eng = Engine(art.graph, art.params, device="cpu").build(image=x)
    out, env = execute(eng.graph, intermediates=True)(eng.params, image=torch.as_tensor(x))
    assert eng.graph.nodes[0].name == "stem" and "s_in" in eng.graph.nodes[0].attrs
    for name in ("stem", "pw"):
        np.testing.assert_array_equal(env[name].numpy(), np.asarray(ref_env[name]), err_msg=name)
    assert np.abs(env["gap__q"].numpy().astype(int)
                  - np.asarray(ref_env["gap__q"]).astype(int)).max() <= 1
    np.testing.assert_array_equal(eng.run(image=x).numpy(), out.numpy())
