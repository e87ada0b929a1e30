"""The port's int8 LRN and int8 concat against tf2_tpu's on the CPU.

``qlrn_plain`` (the plain version of the port's qlrn kernel) is correctly
rounded step by step; tf2_tpu sums the window as an f32 band matmul and
takes ``rsqrt``. They are held to the reference kernel test's own bar
(tests/kernels/test_qlrn.py: max |diff| <= 1, more than 99.9% of elements
exact) against the jitted ``reference_qlrn`` and the Pallas kernel in
interpret mode. The ``fuse_lrn_quantize`` pass must emit the reference's
graph JSON; ``qconcat`` must equal the reference's with tolerance 0. The
kernel itself is held against ``qlrn_plain`` on the card in
tests/test_torch_cuda.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph.ir import GraphBuilder as RefGraphBuilder
from tf2_tpu.graph.ir import Node as RefNode
from tf2_tpu.graph.optimize import fuse_lrn_quantize as ref_fuse_lrn_quantize
from tf2_tpu.kernels import dispatch as ref_dispatch
from tf2_tpu.kernels.qlrn import fused_qlrn as ref_fused_qlrn
from tf2_tpu.kernels.qlrn import reference_qlrn
from tf2_tpu_torch import kernels
from tf2_tpu_torch.graph import Graph, GraphBuilder, Node, execute
from tf2_tpu_torch.graph.optimize import fuse_lrn_quantize
from tf2_tpu_torch.graph.shapes import activation_shapes
from tf2_tpu_torch.kernels import dispatch, qlrn

KW = dict(alpha=2e-4, bias=1.0, s_in=0.0312, s_out=0.0279)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside multi-process JAX tests;
    one intra-op thread keeps these float64 checks from starving them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _within_bar(got: np.ndarray, want: np.ndarray, what: str) -> None:
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{what}: {int((diff != 0).sum())} of {diff.size} elements differ, max {diff.max()}")
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


# the matrix of tests/kernels/test_qlrn.py, and GoogLeNet's lrn_0 shape at
# image 224 with batch 2
@pytest.mark.parametrize("shape,radius,beta", [
    ((2, 8, 8, 64), 2, 0.75),
    ((2, 16, 16, 192), 2, 0.75),
    ((2, 8, 8, 96), 1, 0.5),
    ((2, 56, 56, 64), 2, 0.75),
])
@pytest.mark.parametrize("against", ["reference_qlrn", "pallas_interpret"])
def test_plain_qlrn_matches_reference(shape, radius, beta, against):
    x = np.random.default_rng(0).integers(-127, 128, shape, dtype=np.int8)
    kw = dict(KW, radius=radius, beta=beta)
    if against == "reference_qlrn":
        want = jax.jit(functools.partial(reference_qlrn, **kw))(jnp.asarray(x))
    else:
        want = ref_fused_qlrn(jnp.asarray(x), interpret=True, **kw)
    kernels.reset_launch_counts()
    got = qlrn.qlrn(torch.as_tensor(x), **kw)
    assert kernels.launch_counts()["qlrn"] == 0  # the CPU takes the plain version
    assert got.dtype == torch.int8 and tuple(got.shape) == shape
    _within_bar(got.numpy(), np.asarray(want), f"{shape} r{radius} beta {beta}")


@pytest.mark.parametrize("s_in,s_out,alpha", [(0.5, 0.37, 1e-4), (0.2, 0.05, 1e-3),
                                               (0.0312, 0.0279, 2e-4)])
@pytest.mark.parametrize("radius", [1, 2])
def test_plain_qlrn_scale_sets(s_in, s_out, alpha, radius):
    """The scale sets chip_smoke.py runs the kernel under, where t ranges
    far from 1, on GoogLeNet's lrn_1 channel count."""
    x = np.random.default_rng(radius).integers(-127, 128, (2, 16, 16, 192), dtype=np.int8)
    kw = dict(radius=radius, alpha=alpha, beta=0.75, bias=1.0, s_in=s_in, s_out=s_out)
    want = jax.jit(functools.partial(reference_qlrn, **kw))(jnp.asarray(x))
    got = qlrn.qlrn(torch.as_tensor(x), **kw)
    _within_bar(got.numpy(), np.asarray(want), f"s_in {s_in} s_out {s_out} alpha {alpha} r{radius}")


def test_plain_qlrn_steps():
    """One element by hand: every step rounded to f32, the window sum
    exact, the edge channels' windows clipped to the channels there are."""
    x = np.array([[[[-127, 3, 0, 127, 64, -5, 1]]]], np.int8)
    kw = dict(radius=2, alpha=0.37, beta=0.75, bias=0.5, s_in=0.21, s_out=0.013)
    got = qlrn.qlrn_plain(torch.as_tensor(x), **kw).numpy()
    f = np.float32
    xf = x.astype(f) * f(kw["s_in"])
    sq = (xf * xf).astype(np.float64)
    want = []
    for c in range(7):
        win = f(sq[0, 0, 0, max(c - 2, 0):c + 3].sum())
        t = f(f(win * f(kw["alpha"])) + f(kw["bias"]))
        rs = f(f(1) / np.sqrt(t))
        y = f(f(xf[0, 0, 0, c] * rs) * np.sqrt(rs))
        want.append(np.clip(np.rint(f(y / f(kw["s_out"]))), -127, 127))
    np.testing.assert_array_equal(got.reshape(-1), np.array(want, np.int8))


def test_plain_qlrn_shape_on_meta():
    x = torch.empty((3, 5, 7, 13), dtype=torch.int8, device="meta")
    y = qlrn.fused_qlrn(x, plain=True, radius=2, beta=0.75, **KW)
    assert y.shape == x.shape and y.dtype == torch.int8 and y.device.type == "meta"


def _chain_graph(builder, pool: bool, extra_consumer: bool):
    """The graphs of tests/kernels/test_qlrn.py: dequantize -> lrn ->
    (maxpool) -> quantize, and an lrn with a second consumer."""
    b = builder("m")
    shape = (1, 4, 4, 32) if extra_consumer else (2, 8, 8, 64)
    x = b.input("x", shape, "int8")
    d = b.raw("dequantize", [x], name="dq", scale=0.05)
    if extra_consumer:
        l = b.lrn(d, name="l")
        q = b.raw("quantize", [l], name="q", scale=0.04)
        return b.build([q, b.raw("identity", [l], name="keep")])
    l = b.lrn(d, radius=2, alpha=2e-4, beta=0.75, bias=1.0, name="l")
    if pool:
        l = b.maxpool(l, 2, 2, name="mp")
    return b.build(b.raw("quantize", [l], name="q", scale=0.04))


@pytest.mark.parametrize("case", ["plain", "maxpool", "two_consumers"])
def test_fuse_lrn_quantize_matches_reference(case):
    """The same graph JSON as the reference pass: the single qlrn, the
    maxpool commuted after it onto int8, and no fusion when the lrn has a
    second consumer. The fused values stay within the bar of the port's
    own unfused chain, and the unfused chain within it of the reference's."""
    pool, two = case == "maxpool", case == "two_consumers"
    ref_g = _chain_graph(RefGraphBuilder, pool, two)
    g = _chain_graph(GraphBuilder, pool, two)
    assert g.to_json() == ref_g.to_json()
    ref_fused, _ = ref_fuse_lrn_quantize(ref_g, {})
    fused, _ = fuse_lrn_quantize(Graph.from_json(ref_g.to_json()), {})
    assert fused.to_json() == ref_fused.to_json()
    assert [n.op for n in fused.nodes] == {"plain": ["qlrn"], "maxpool": ["qlrn", "maxpool"],
                                           "two_consumers": [n.op for n in g.nodes]}[case]
    x = np.random.default_rng(2).integers(-127, 128, g.inputs["x"].shape, dtype=np.int8)
    unfused = execute(g)({}, x=torch.as_tensor(x))
    got = execute(fused)({}, x=torch.as_tensor(x))
    ref_unfused = ref_execute(ref_g)({}, x=jnp.asarray(x))
    if two:  # outputs (q, keep): nothing was fused
        assert all(torch.equal(a, b) for a, b in zip(got, unfused))
        unfused, ref_unfused = unfused[0], ref_unfused[0]
    else:
        _within_bar(got.numpy(), unfused.numpy(), f"{case}: fused against unfused")
    _within_bar(unfused.numpy(), np.asarray(ref_unfused), f"{case}: unfused against tf2_tpu")


def test_fused_graph_shapes():
    fused, _ = fuse_lrn_quantize(_chain_graph(GraphBuilder, True, False), {})
    shapes = activation_shapes(fused)
    assert shapes["l__qlrn"] == (2, 8, 8, 64) and shapes["q"] == (2, 4, 4, 64)


@pytest.mark.parametrize("in_scales,out_scale", [
    ((0.02, 0.02, 0.02), 0.02),              # equal: a byte copy
    ((0.031, 0.02, 0.0137), 0.02),           # one equal, two requantized
    ((0.5, 0.0011), 0.0173),                 # clipping at both ends
])
def test_qconcat_matches_reference(in_scales, out_scale):
    rng = np.random.default_rng(len(in_scales))
    xs = [rng.integers(-127, 128, (2, 5, 5, c), dtype=np.int8)
          for c in (16, 24, 8)[:len(in_scales)]]
    attrs = {"in_scales": list(in_scales), "out_scale": out_scale, "axis": -1}
    names = [f"x{i}" for i in range(len(xs))]
    want = ref_dispatch.qconcat(RefNode("c", "qconcat", names, (), attrs), {},
                                *map(jnp.asarray, xs))
    got = dispatch.qconcat(Node("c", "qconcat", names, (), attrs), {},
                           *map(torch.as_tensor, xs))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
