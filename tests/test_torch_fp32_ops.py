"""The port's f32 executors of the ops no zoo Engine runs (``batch_norm``,
``attention``, ``relu6``, ``sigmoid``, ``mul``, ``avgpool``) against
tf2_tpu's on the CPU, the four ``GraphBuilder`` methods added with them,
and BN folding.

Tolerances, each measured on these seeds and stated per op:
- ``relu6``, ``mul``: 0 (one correctly rounded step each).
- ``batch_norm``: the port divides 1 by a correctly rounded square root
  (``build.sqrt_rn``) where the reference takes XLA's f32 ``rsqrt``, which
  is not correctly rounded, so the two ``inv`` can differ in the last bit;
  x * inv and offset - mean * inv then cancel in some outputs, so the bound
  is relative to the largest output: ``BN_RTOL`` (measured 1.84e-7, 526
  of 4,320 outputs differ).
- ``sigmoid``: neither side is correctly rounded; at most ``SIGMOID_ULPS``.
- ``avgpool``: the port sums the window in float64 and divides once; XLA
  sums in f32, whose rounding shows where a window's values cancel, so the
  bound is relative to the largest output: ``AVGPOOL_RTOL`` (VALID and
  SAME, the SAME count being the window's elements inside the input;
  measured at most 2.15e-7, at 7x7 VALID).
- ``attention``: f32 matmuls in another order and the port's softmax
  (exp in float64), relative ``ATTN_RTOL`` of the output's largest value
  (measured at most 3.42e-7).
- the whole ``fp32_ops_graph``: each node within 1e-5 of its largest
  value (measured at most 4.36e-7, the attention) and the logits within
  ``GRAPH_RTOL`` (measured 5.78e-7).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.ir import GraphBuilder as RefBuilder
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu_torch.bench.coverage_cases import fp32_ops_graph
from tf2_tpu_torch.graph import GraphBuilder, execute
from tf2_tpu_torch.graph.execute import no_tf32
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.transform import fold_batch_norm

BN_RTOL = 2.0 ** -21
SIGMOID_ULPS = 2
AVGPOOL_RTOL = 2.0 ** -21
ATTN_RTOL = 2e-6
NODE_RTOL = 1e-5
# the whole fp32_ops_graph (conv, every op above, attention, the dense):
# max |port - reference| / max |reference| of the logits
GRAPH_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in f32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2 ** 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2 ** 31)) - ib, ib)
    return int(np.abs(ia - ib).max())


def _both(build, shapes: dict, seed: int = 0):
    """The same graph from both builders (equal JSON), random params and
    inputs from one numpy seed; -> (port output, reference output)."""
    pg, rg = build(GraphBuilder), build(RefBuilder)
    assert json.loads(pg.to_json()) == json.loads(rg.to_json())
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
              for k, v in pg.params.items()}
    for k in params:
        if k.endswith(".var"):
            params[k] = np.abs(params[k]) + np.float32(0.1)
    inputs = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in shapes.items()}
    got = execute(pg)({k: torch.as_tensor(v) for k, v in params.items()},
                      **{k: torch.as_tensor(v) for k, v in inputs.items()})
    want = ref_execute(rg)({k: jnp.asarray(v) for k, v in params.items()},
                           **{k: jnp.asarray(v) for k, v in inputs.items()})
    return got.numpy(), np.asarray(want)


def _unary(op: str, c: int = 24):
    def build(builder):
        b = builder(op)
        x = b.input("x", (2, 9, 10, c))
        if op == "batch_norm":
            y = b.batch_norm(x, c, eps=1e-3, name="y")
        elif op == "sigmoid":
            y = b.sigmoid(x, name="y")
        else:
            y = b.raw(op, [x], name="y")
        return b.build(y)
    return build


def test_relu6_exact():
    got, want = _both(_unary("relu6"), {"x": (2, 9, 10, 24)})
    np.testing.assert_array_equal(got, want)
    assert (got == 6).any() and (got == 0).any()


def test_mul_exact():
    def build(builder):
        b = builder("mul")
        x, y = b.input("x", (2, 5, 7, 16)), b.input("y", (2, 5, 7, 16))
        return b.build(b.raw("mul", [x, y], name="y_mul"))
    got, want = _both(build, {"x": (2, 5, 7, 16), "y": (2, 5, 7, 16)})
    np.testing.assert_array_equal(got, want)


def test_batch_norm_matches_reference():
    got, want = _both(_unary("batch_norm"), {"x": (2, 9, 10, 24)})
    assert np.abs(got - want).max() <= BN_RTOL * np.abs(want).max()


def test_sigmoid_within_ulps():
    got, want = _both(_unary("sigmoid"), {"x": (2, 9, 10, 24)})
    assert _ulps(got, want) <= SIGMOID_ULPS


@pytest.mark.parametrize("window,stride,padding,size", [
    (3, 1, "SAME", (9, 10)), (3, 2, "SAME", (10, 10)), (3, 2, "SAME", (9, 11)),
    (2, 2, "SAME", (7, 8)), (5, 3, "SAME", (11, 13)), (2, 2, "VALID", (8, 9)),
    (3, 2, "VALID", (9, 10)), (7, 1, "VALID", (7, 7))])
def test_avgpool_matches_reference(window, stride, padding, size):
    """SAME divides by the count of the window's elements inside the input
    (asymmetric pads where the size is even at stride 2)."""
    def build(builder):
        b = builder("avgpool")
        x = b.input("x", (2, *size, 24))
        return b.build(b.avgpool(x, window, stride, padding=padding, name="y"))
    got, want = _both(build, {"x": (2, *size, 24)})
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= AVGPOOL_RTOL * np.abs(want).max()


@pytest.mark.parametrize("dim,heads,t", [(48, 2, 16), (64, 4, 37), (96, 3, 9)])
def test_attention_matches_reference(dim, heads, t):
    def build(builder):
        b = builder("attention")
        x = b.input("x", (2, t, dim))
        return b.build(b.attention(x, dim, heads, name="attn"))
    got, want = _both(build, {"x": (2, t, dim)})
    assert np.abs(got - want).max() <= ATTN_RTOL * np.abs(want).max()


@pytest.mark.parametrize("method,args", [
    ("attention", dict(dim=48, heads=3)), ("sigmoid", {}),
    ("avgpool", dict(window=3, stride=2, padding="SAME")), ("flatten", {})])
def test_graph_builder_methods_match_reference(method, args):
    """The four methods added to the port's GraphBuilder build the
    reference's JSON."""
    def build(builder):
        b = builder("m")
        x = b.input("x", (2, 4, 48) if method == "attention" else (2, 6, 6, 48))
        y = getattr(b, method)(x, **args)
        return b.build(getattr(b, method)(y, **args) if method != "flatten" else y)
    assert json.loads(build(GraphBuilder).to_json()) == json.loads(build(RefBuilder).to_json())


def test_fp32_ops_graph_matches_reference():
    """``bench/coverage_cases.fp32_ops_graph`` (every op above in one graph,
    the graph ``chip_smoke.py`` phase 19 runs on the card) against the
    reference's forward, every node within ``NODE_RTOL`` and the logits
    within ``GRAPH_RTOL`` of their largest value."""
    pg, rg = fp32_ops_graph(GraphBuilder), fp32_ops_graph(RefBuilder)
    assert json.loads(pg.to_json()) == json.loads(rg.to_json())
    params = {k: np.asarray(v) for k, v in ref_init_params(rg, seed=1).items()}
    x = np.random.default_rng(1).standard_normal(rg.inputs["image"].shape).astype(np.float32)
    with no_tf32():
        out, env = execute(pg, intermediates=True)(
            {k: torch.as_tensor(v) for k, v in params.items()}, image=torch.as_tensor(x))
    ref_out, ref_env = ref_execute(rg, intermediates=True)(params, image=jnp.asarray(x))
    assert {n.op for n in pg.nodes} >= {"batch_norm", "relu6", "sigmoid", "mul", "avgpool",
                                        "attention", "flatten"}
    for name in ("conv", "bn", "relu6", "gate", "swish", "avg_same", "avg_same_s2",
                 "avg_valid", "attn"):
        a, b = env[name].numpy(), np.asarray(ref_env[name])
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= NODE_RTOL * np.abs(b).max(), name
    ref_out = np.asarray(ref_out)
    assert np.abs(out.numpy() - ref_out).max() <= GRAPH_RTOL * np.abs(ref_out).max()


def test_bn_fold_exact():
    """tests/transform/test_pipeline.py::test_bn_fold_exact on the port:
    the folded graph has no batch_norm and its forward equals the unfolded
    one's within the reference test's bounds; the folded graph and params
    equal the reference's fold of the same params."""
    g = get_model("resnet50", batch=1, image=32, classes=10, depths=(1, 1, 1, 1))
    rg = ref_get_model("resnet50", batch=1, image=32, classes=10, depths=(1, 1, 1, 1))
    params = {k: np.asarray(v) for k, v in ref_init_params(rg, seed=0).items()}
    fg, fp = fold_batch_norm(g, params)
    assert not any(n.op == "batch_norm" for n in fg.nodes)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        g.inputs["image"].shape).astype(np.float32))
    tp = lambda p: {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}  # noqa: E731
    y0 = execute(g)(tp(params), image=x).numpy()
    y1 = execute(fg)(tp(fp), image=x).numpy()
    np.testing.assert_allclose(y0, y1, atol=2e-4, rtol=1e-3)
    rfg, rfp = ref_fold(rg, params)
    assert fg.to_json() == rfg.to_json()
    for k, v in rfp.items():
        np.testing.assert_array_equal(fp[k], np.asarray(v), err_msg=k)
    y_ref = np.asarray(jax.jit(ref_execute(rg))(params, image=jnp.asarray(x.numpy())))
    np.testing.assert_allclose(y0, y_ref, atol=2e-4, rtol=1e-3)
