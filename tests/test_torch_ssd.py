"""The port's SSD path against tf2_tpu's on the CPU: batch 2, image 128, 21
classes, 252 priors, W4-PoT with activation scales from the reference's
calibration, under both score cases of ``tf2_tpu_torch/bench/ssd_cases.py``
(the random weights' scores, and the background-dominated ones).

Tolerance 0 for the builder, the quantizer (graph JSON, tensor hashes),
the Engine graphs and every int8 node. The f32 head is held to stated
bounds (scores in units of the f32 spacing of the reference's value,
boxes absolute): the
port takes each exp in float64 rounded once, sums the softmax in float64
and divides by IEEE division (so that the card and the CPU agree bit for
bit), where XLA's f32 ``exp`` and softmax are not correctly rounded. The
NMS is exact: on the reference's own inputs the port's detections equal
the reference's. End to end, the detections have the same classes and the
same keep set; boxes and scores stay within the bounds below, each
differing element counted and printed (ROADMAP Queue 3)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph.execute import _OP_IMPLS as REF_OPS
from tf2_tpu.kernels import detection as ref_detection
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.models.ssd import init_priors as ref_init_priors
from tf2_tpu.models.ssd import make_priors as ref_make_priors
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch.bench.ssd_cases import CASES, case_params
from tf2_tpu_torch.graph import Node, init_params
from tf2_tpu_torch.graph.execute import _OP_IMPLS
from tf2_tpu_torch.kernels import detection
from tf2_tpu_torch.models import get_model, ssd, synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.runtime.engine import _decode_pot4
from tf2_tpu_torch.transform import QuantSpec, fold_batch_norm, from_reference, quantize_graph
from tf2_tpu_torch.transform.export import _hash

SMALL = dict(batch=2, image=128, classes=21)
# the port's Engine routes against the reference Engine's flags: the
# reference's default (phase_stem and merge_1x1 on), the port's default,
# and the space-to-depth stem
ROUTES = {"phase_stem": (dict(phase_stem=True, merge_1x1=True), {}),
          "default": ({}, dict(phase_stem=False, merge_1x1=False)),
          "optimize": (dict(optimize=True), dict(optimize=True, phase_stem=False))}
# Bounds, set from the CPU measurement with these seeds (the tests print
# it): scores within SCORE_ULPS ulps of the reference's f32 value
# (np.spacing; measured at most 24), box coordinates (|x| < 2, where a
# difference near 0 is cancellation) within BOX_ATOL (measured 2^-23)
SCORE_ULPS = 32
BOX_ATOL = 2.0 ** -22


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside multi-process JAX tests;
    one intra-op thread keeps these float64 checks from starving them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32))


@pytest.fixture(scope="module")
def art():
    """The reference's calibrated W4 SSD artifact (weights drawn with numpy,
    the priors from ``init_priors``) and the image."""
    g = ref_get_model("ssd", **SMALL)
    params = init_params(g, seed=0)
    params.update(ref_init_priors(g))
    fg, fp = ref_fold(g, params)
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    art = ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=4, pot_candidates=5))
    return dict(g=g, params=params, scales=scales, art=art, x=x)


@pytest.fixture(scope="module", params=[(r, c) for r in ROUTES for c in CASES])
def run(request, art):
    """One Engine route under one score case: both Engines, the
    reference's values of every node and its detections."""
    route, case = request.param
    port_kw, ref_kw = ROUTES[route]
    a = art["art"]
    params = case_params(case, a.graph, a.params)
    ref = RefEngine(a.graph, params, **ref_kw)
    out, env = jax.jit(ref_execute(ref.graph, intermediates=True))(ref.params,
                                                                    image=jnp.asarray(art["x"]))
    eng = Engine(*from_reference(a.graph.to_json(), params), device="cpu", **port_kw)
    return dict(route=route, case=case, ref=ref, eng=eng, x=art["x"], out=np.asarray(out),
                env={k: np.asarray(v) for k, v in env.items()})


def test_builder_and_priors_match_reference(art):
    assert get_model("ssd", **SMALL).to_json() == art["g"].to_json()
    assert get_model("ssd").to_json() == ref_get_model("ssd").to_json()
    np.testing.assert_array_equal(ssd.init_priors(art["g"])["priors"],
                                  ref_init_priors(art["g"])["priors"])
    np.testing.assert_array_equal(ssd.make_priors([16, 8, 4], 256, ssd.SCALES),
                                  ref_make_priors([16, 8, 4], 256, ssd.SCALES))
    assert ssd.init_priors(ssd.build())["priors"].shape == (1008, 4)


def test_quantizer_matches_reference(art):
    pfg, pfp = fold_batch_norm(get_model("ssd", **SMALL), art["params"])
    part = quantize_graph(pfg, pfp, art["scales"], QuantSpec(weight_bits=4, pot_candidates=5))
    assert part.graph.to_json() == art["art"].graph.to_json()
    assert {k: _hash(v) for k, v in part.params.items()} == \
        {k: _hash(np.asarray(v)) for k, v in art["art"].params.items()}
    ops = [n.op for n in part.graph.nodes]
    assert ops[-5:] == ["dequantize", "softmax", "dequantize", "box_decode", "nms"]


def test_synthetic_artifact_loads_the_priors():
    a = synthetic_quantized("ssd", batch=1, image=64)
    np.testing.assert_array_equal(a.params["priors"],
                                  ssd.init_priors(a.graph)["priors"])


def test_engine_graph_matches_reference(run):
    """The port Engine's graph is the reference Engine's once the convs the
    port keeps packed are decoded too; the stem node is the route's."""
    eng = run["eng"]
    params = {k: v.numpy() for k, v in eng.params.items()}
    pot4 = {n.name for n in eng.graph.nodes if n.attrs.get("wfmt") == "pot4"}
    decoded, _ = _decode_pot4(eng.graph, params, pot4)
    assert json.loads(decoded.to_json()) == json.loads(run["ref"].graph.to_json())
    stem = next(n for n in eng.graph.nodes if n.op == "qconv2d")
    want = {"phase_stem": ("wpack2", [2, 2]), "default": ("int8", [2, 2]),
            "optimize": ("int8", [1, 1])}[run["route"]]
    assert (stem.attrs["wfmt"], stem.attrs["strides"]) == want


def test_every_int8_node_equals_reference(run):
    """Each int8 node of the port's Engine graph, fed the reference's own
    input values, equals the reference's node exactly: the 14 backbone and
    head convs, the two qconcats and the four reshapes."""
    eng, env = run["eng"], run["env"]
    checked = 0
    for n in eng.graph.nodes:
        if env[n.name].dtype != np.int8:
            continue
        impl, takes_plain = _OP_IMPLS[n.op]
        args = [torch.tensor(env[i]) for i in n.inputs]
        got = (impl(n, eng.params, *args, plain=False) if takes_plain
               else impl(n, eng.params, *args)).numpy()
        np.testing.assert_array_equal(got, env[n.name], err_msg=n.name)
        checked += 1
    assert checked == 14 + 2 + 6


def test_softmax_and_decode_within_bounds(run):
    """On the reference's own inputs: the scores within SCORE_ULPS, the
    boxes within BOX_ATOL of the reference's f32 values."""
    eng, env = run["eng"], run["env"]
    nodes = eng.graph.node_map()
    got = {name: _OP_IMPLS[nodes[name].op][0](nodes[name], eng.params,
                                              torch.tensor(env[nodes[name].inputs[0]])).numpy()
           for name in ("scores", "boxes")}
    ulps, diff = _ulps(got["scores"], env["scores"]), np.abs(got["boxes"] - env["boxes"])
    print(f"{run['route']}/{run['case']}: scores {int((ulps > 0).sum())} of {ulps.size} differ, "
          f"at most {ulps.max():.0f} ulps; boxes {int((diff > 0).sum())} of {diff.size}, "
          f"at most {diff.max():.3g}")
    assert ulps.max() <= SCORE_ULPS and diff.max() <= BOX_ATOL


def test_nms_on_reference_inputs_is_exact(run):
    """The port's NMS on the reference's boxes and scores gives the
    reference's detections bit for bit."""
    eng, env = run["eng"], run["env"]
    n = eng.graph.node_map()["detections"]
    got = _OP_IMPLS["nms"][0](n, eng.params, torch.tensor(env["boxes"]),
                              torch.tensor(env["scores"])).numpy()
    np.testing.assert_array_equal(got, env["detections"])


def test_detections_match_reference(run):
    """End to end from the image: the same classes in the same order and
    the same keep set (score > 0); scores within SCORE_ULPS, boxes within
    BOX_ATOL. The random case keeps all 200 rows, the background case 11
    of them."""
    got = run["eng"].run(image=run["x"]).numpy()
    want = run["out"]
    assert got.shape == want.shape == (2, 100, 6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    ulps, diff = _ulps(got[..., 4], want[..., 4]), np.abs(got[..., :4] - want[..., :4])
    print(f"{run['route']}/{run['case']} detections: scores {int((ulps > 0).sum())} of "
          f"{ulps.size} differ, at most {ulps.max():.0f} ulps; boxes {int((diff > 0).sum())} "
          f"of {diff.size}, at most {diff.max():.3g}; {int((want[..., 4] > 0).sum())} kept")
    assert ulps.max() <= SCORE_ULPS and diff.max() <= BOX_ATOL
    assert int((want[..., 4] > 0).sum()) == {"random": 200, "background": 11}[run["case"]]


def _random_instance(rng, a: int, clusters: int = 8):
    """tests/kernels/test_detection.py's clustered boxes."""
    centers = rng.uniform(0.1, 0.9, (clusters, 2))
    cx = centers[rng.integers(0, clusters, a)] + rng.normal(0, 0.03, (a, 2))
    wh = rng.uniform(0.05, 0.25, (a, 2))
    boxes = np.concatenate([cx - wh / 2, cx + wh / 2], -1).astype(np.float32)
    return boxes, rng.uniform(0, 1, a).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_nms_single_class_keep_matches_reference(seed):
    boxes, scores = _random_instance(np.random.default_rng(seed), a=96)
    want = ref_detection.nms_single_class(jnp.asarray(boxes), jnp.asarray(scores), 64, 0.45)
    got = detection.nms_single_class(torch.as_tensor(boxes), torch.as_tensor(scores), 64, 0.45)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_deep_chain_matches_reference():
    """Each box overlaps only its neighbour: greedy keeps every other one,
    the deepest fixpoint there is."""
    k = 32
    x = np.arange(k, dtype=np.float32) * 0.4
    boxes = np.stack([x, np.zeros(k, np.float32), x + 1.0, np.ones(k, np.float32)], -1)
    scores = np.linspace(1.0, 0.5, k).astype(np.float32)
    _, _, keep = detection.nms_single_class(torch.as_tensor(boxes), torch.as_tensor(scores),
                                            k, 0.4)
    _, _, want = ref_detection.nms_single_class(jnp.asarray(boxes), jnp.asarray(scores), k, 0.4)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
    assert keep.tolist() == [i % 2 == 0 for i in range(k)]


@pytest.mark.parametrize("levels", [3, 12])
def test_batched_nms_ties_pick_the_references_order(levels):
    """Scores on a few levels (as the softmax of dequantized int8 logits
    gives), many of them under the threshold: equal scores keep the lower
    index first, so the zero-score rows carry the reference's classes."""
    rng = np.random.default_rng(levels)
    n, a, c = 3, 150, 6
    boxes = np.stack([_random_instance(rng, a)[0] for _ in range(n)])
    grid = np.float32([0.0, 0.004, 0.3, 0.5, 0.02, 0.7, 0.1, 0.05, 0.9, 0.2, 0.6, 0.25])[:levels]
    p = np.full(levels, 0.02 / (levels - 2))
    p[:2] = 0.49  # 98% of the candidates under the threshold
    scores = rng.choice(grid, size=(n, a, c), p=p).astype(np.float32)
    kw = dict(max_out=40, topk=64, iou_thresh=0.45, score_thresh=0.01)
    want = np.asarray(ref_detection.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw))
    got = detection.batched_nms(torch.as_tensor(boxes), torch.as_tensor(scores), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[..., 4] == 0).any()


def test_softmax_and_decode_match_reference_ops():
    """The f32 ops on seeded inputs: the softmax of dequantized int8
    logits and the decode of dequantized deltas, within the bounds."""
    rng = np.random.default_rng(0)
    logits = rng.integers(-127, 128, (2, 252, 21)).astype(np.float32) * np.float32(0.0371)
    node = Node("s", "softmax", ("x",), (), {})
    got = _OP_IMPLS["softmax"][0](node, {}, torch.as_tensor(logits)).numpy()
    want = np.asarray(REF_OPS["softmax"](node, {}, jnp.asarray(logits)))
    assert _ulps(got, want).max() <= SCORE_ULPS
    np.testing.assert_allclose(got.astype(np.float64).sum(-1), 1.0, atol=1e-6)
    loc = rng.integers(-127, 128, (2, 252, 4)).astype(np.float32) * np.float32(0.05)
    priors = ref_make_priors([8, 4, 2], 128, ssd.SCALES)
    got = detection.decode_boxes(torch.as_tensor(loc), torch.as_tensor(priors)).numpy()
    want = np.asarray(ref_detection.decode_boxes(jnp.asarray(loc), jnp.asarray(priors)))
    assert np.abs(got - want).max() <= BOX_ATOL
