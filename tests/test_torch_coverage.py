"""Shapes the reference runs and the port's kernels do not take, against
tf2_tpu on the CPU, and the Engine's coverage plan.

- ``qconv.fused_qconv2d`` (``qconv_plain``) on CPU tensors for grouped,
  depthwise and odd-strided convs, against the reference's
  ``dispatch.qconv2d`` on its XLA path (Pallas off, as off the TPU), at
  tolerance 0.
- ``coverage_cases.conv_graph`` (a depthwise, a ``groups=2``, a stride-3
  and a (1, 2)-strided conv) from the builder through the quantizer to the
  Engine, node by node against the reference Engine.
- ``Engine.plan``: the names it gives as a function of the graph and of
  each kernel's predicate, called with the card's limits (and tighter
  ones) so that it runs here; ``execute(kernels=)`` flags exactly the
  nodes it names plain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.ir import GraphBuilder as RefGraphBuilder
from tf2_tpu.graph.ir import Node as RefNode
from tf2_tpu.kernels import dispatch as ref_dispatch
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import potq as ref_potq
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch import kernels
from tf2_tpu_torch.bench import coverage_cases
from tf2_tpu_torch.graph import GraphBuilder, execute
from tf2_tpu_torch.graph.execute import _OP_IMPLS
from tf2_tpu_torch.kernels import dispatch, qblocks, qconv
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.runtime.engine import Limits
from tf2_tpu_torch.transform import QuantSpec, fold_batch_norm, from_reference, quantize_graph
from tf2_tpu_torch.transform.export import _hash

CARD = Limits(qlrn_channels=(48 * 1024 - 64) // 6, smem_per_block=qblocks.SMEM_LIMIT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside multi-process JAX tests;
    one intra-op thread keeps these float64 checks from starving them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_conv(x, wparam, es, eb, attrs):
    node = RefNode("c", "qconv2d", ("x",), ("w", "es", "eb"), attrs)
    params = {"w": jnp.asarray(wparam), "es": jnp.asarray(es), "eb": jnp.asarray(eb)}
    prev = ref_dispatch._USE_PALLAS
    ref_dispatch.set_use_pallas(False)
    try:
        return np.asarray(ref_dispatch.qconv2d(node, params, jnp.asarray(x)))
    finally:
        ref_dispatch.set_use_pallas(prev)


@pytest.mark.parametrize("b,h,w,cin,cout,k,strides,padding,groups,wfmt", [
    (2, 9, 9, 16, 16, 3, (1, 1), "SAME", 16, "int8"),     # depthwise
    (2, 9, 9, 16, 16, 3, (1, 1), "VALID", 16, "pot4"),    # depthwise, odd K
    (2, 10, 10, 32, 48, 3, (1, 1), "VALID", 2, "pot4"),   # groups=2
    (2, 11, 11, 32, 64, 1, (1, 1), "SAME", 4, "pot4"),    # grouped 1x1
    (2, 14, 14, 24, 32, 3, (3, 3), "SAME", 1, "int8"),    # stride 3
    (2, 11, 13, 16, 24, 3, (1, 2), "SAME", 1, "pot4"),    # stride (1, 2)
    (1, 13, 9, 8, 16, 5, (3, 1), "VALID", 1, "int8"),     # stride (3, 1)
    (2, 12, 12, 32, 32, 3, (2, 2), "SAME", 2, "int8"),    # grouped, stride 2
])
@pytest.mark.parametrize("relu", [False, True])
def test_uncovered_conv_plain_matches_reference(b, h, w, cin, cout, k, strides, padding,
                                                groups, wfmt, relu):
    rng = np.random.default_rng(cin * cout + k + groups)
    kk = k * k * (cin // groups)
    x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    if wfmt == "pot4":
        q, _ = ref_potq.fit_pot(rng.standard_normal((kk, cout)).astype(np.float32) * 0.05)
        wparam = ref_potq.pack_codes(ref_potq.pot_encode_from_int8(q))
    else:
        wparam = rng.integers(-127, 128, (k, k, cin // groups, cout), dtype=np.int8)
    es = (rng.uniform(0.5, 3.0, cout) / (127 * np.sqrt(kk))).astype(np.float32)
    eb = rng.normal(0, 10, cout).astype(np.float32)
    kshape = (k, k, cin // groups, cout)
    assert not qconv.covers(kshape, strides, groups)
    want = _reference_conv(x, wparam, es, eb, {
        "kshape": list(kshape), "strides": list(strides), "padding": padding,
        "groups": groups, "relu": relu, "wfmt": wfmt})
    kernels.reset_launch_counts()
    got = qconv.fused_qconv2d(*(torch.as_tensor(a) for a in (x, wparam, es, eb)),
                              strides=strides, padding=padding, groups=groups, relu=relu,
                              wfmt=wfmt, kshape=kshape)
    assert set(kernels.launch_counts().values()) == {0}
    assert got.is_contiguous() and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((want != 0).sum()) > want.size // 4 and int((np.abs(want) < 127).sum()) > 0


@pytest.fixture(scope="module")
def conv_case():
    """coverage_cases.conv_graph through both packages: the reference's
    calibration, quantizer and Engine, and the port's on the same
    params and scales."""
    g = coverage_cases.conv_graph(RefGraphBuilder)
    params = {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()}
    fg, fp = ref_fold(g, params)
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    spec = dict(weight_bits=4, pot_candidates=5)
    art = ref_quantize_graph(fg, fp, scales, RefQuantSpec(**spec))
    ref = RefEngine(art.graph, art.params)
    logits, env = jax.jit(ref_execute(ref.graph, intermediates=True))(
        ref.params, image=jnp.asarray(x))
    return dict(g=g, params=params, scales=scales, spec=spec, art=art, x=x,
                ref_env={k: np.asarray(v) for k, v in env.items()},
                ref_logits=np.asarray(logits))


def test_conv_graph_builder_and_quantizer_match_reference(conv_case):
    pg = coverage_cases.conv_graph(GraphBuilder)
    assert pg.to_json() == conv_case["g"].to_json()
    part = quantize_graph(*fold_batch_norm(pg, conv_case["params"]), conv_case["scales"],
                          QuantSpec(**conv_case["spec"]))
    assert part.graph.to_json() == conv_case["art"].graph.to_json()
    assert {k: _hash(v) for k, v in part.params.items()} == \
        {k: _hash(np.asarray(v)) for k, v in conv_case["art"].params.items()}
    groups = {n.name: n.attrs["groups"] for n in part.graph.nodes if n.op == "qconv2d"}
    assert groups == {"stem": 1, "dw3x3": 16, "pw1x1": 1, "g2_3x3": 2, "s3_3x3": 1,
                      "s12_3x3": 1}


def test_conv_graph_engine_every_node_equals_reference(conv_case):
    eng = Engine(*from_reference(conv_case["art"].graph.to_json(), conv_case["art"].params),
                 device="cpu")
    assert eng.plain_nodes == frozenset()
    kernels.reset_launch_counts()
    logits, env = execute(eng.graph, intermediates=True)(
        eng.params, image=torch.as_tensor(conv_case["x"]))
    assert set(kernels.launch_counts().values()) == {0}
    checked = 0
    for n in eng.graph.nodes:
        want = conv_case["ref_env"][n.name]
        if want.dtype == np.int8:
            np.testing.assert_array_equal(env[n.name].numpy(), want, err_msg=n.name)
            checked += 1
    assert checked == 8  # six convs (the stem with the input quantize), gap__q, head
    np.testing.assert_array_equal(logits.numpy(), conv_case["ref_logits"])
    np.testing.assert_array_equal(eng.run(image=conv_case["x"]).numpy(),
                                  conv_case["ref_logits"])


def _plan(art, limits=CARD, **flags):
    eng = Engine(art.graph, art.params, device="cpu", **flags)
    return dispatch.nodes_on(Engine.plan(eng.graph, eng.params, limits), "plain")


def test_plan_names_what_no_kernel_takes():
    """Each kernel's predicate decides: the convs the conv kernels do not
    take, an attention core of head width 24; dense layers and the glue
    never appear. On the CPU an Engine plans nothing."""
    conv = coverage_cases.conv_artifact()
    assert _plan(conv) == coverage_cases.CONV_PLAIN
    assert Engine(conv.graph, conv.params, device="cpu").plain_nodes == frozenset()
    assert _plan(coverage_cases.tiny_vit_hd24()) == {"blk0_attn"}
    # ViT at T = 530 (image 368, class token): the kernel takes any T now
    vit = synthetic_quantized("vit_b16_cls", batch=1, image=368, classes=10, dim=64, depth=1,
                              heads=2, weight_bits=8)
    assert _plan(vit) == frozenset()


def test_plan_asks_the_card_limits():
    """qlrn's channel limit and the chain kernel's shared memory are the
    card's: passed in, they decide GoogLeNet's LRNs and ResNet-50's
    chains."""
    goog = synthetic_quantized("googlenet", batch=1, image=64, classes=10, weight_bits=8)
    lrns = [n for n in Engine(goog.graph, goog.params, device="cpu").graph.nodes
            if n.op == "qlrn"]
    assert len(lrns) == 2
    assert _plan(goog) == frozenset()
    assert _plan(goog, Limits(64, CARD.smem_per_block)) == {lrns[1].name}  # 192 channels
    assert _plan(goog, Limits(63, CARD.smem_per_block)) == {n.name for n in lrns}
    res = synthetic_quantized("resnet50", batch=1, image=64, classes=10, depths=(2, 2, 2, 2),
                              weight_bits=8)
    chains = [n.name for n in Engine(res.graph, res.params, device="cpu",
                                     block_fusion=True).graph.nodes if n.op == "qblockchain"]
    assert len(chains) == 4
    assert _plan(res, block_fusion=True) == frozenset()
    assert _plan(res, Limits(CARD.qlrn_channels, 0), block_fusion=True) == set(chains)
    assert _plan(res, Limits(CARD.qlrn_channels, 0), block_fusion=False) == frozenset()


def test_execute_runs_plain_nodes_plain(monkeypatch):
    """execute(kernels=) hands kernel="plain" to exactly the nodes it names
    plain."""
    art = coverage_cases.conv_artifact()
    impl, takes_kernel = _OP_IMPLS["qconv2d"]
    seen = {}

    def recording(node, params, x, kernel=None):
        seen[node.name] = kernel == "plain"
        return impl(node, params, x, kernel=kernel)

    monkeypatch.setitem(_OP_IMPLS, "qconv2d", (recording, takes_kernel))
    eng = Engine(art.graph, art.params, device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 32, 32, 3)),
                        dtype=torch.float32)
    want = eng.run(image=x)
    got = execute(eng.graph, kernels=dict.fromkeys(coverage_cases.CONV_PLAIN, "plain"))(
        eng.params, image=x)
    assert {k for k, v in seen.items() if v} == coverage_cases.CONV_PLAIN
    assert torch.equal(got, want)
