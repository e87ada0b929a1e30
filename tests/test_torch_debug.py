"""The port's debug utilities (``tf2_tpu_torch/utils/debug.py``) on the CPU,
against tf2_tpu: the four cases of tests/test_debug_utils.py on the port
(SqueezeNet v1.1 at 32x32, 10 classes), ``check_finite`` naming the node
the reference's names on the same poisoned params, ``checked_execute``'s
NaN and index checks, ``compare_backends`` empty on the CPU, and
``plain_mode`` reaching every node and switching off again. No test enters
Pallas interpret mode: the reference's ``check_finite`` runs its f32 graph
on its jnp path."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.utils.debug import check_finite as ref_check_finite
from tf2_tpu_torch.graph import execute, init_params
from tf2_tpu_torch.graph.ir import Graph, Node, TensorSpec
from tf2_tpu_torch.models import get_model, synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import QuantSpec, transform_model
from tf2_tpu_torch.transform.cli import calibration_batches
from tf2_tpu_torch.utils.debug import (check_finite, checked_execute, compare_backends,
                                       plain_mode)

SQUEEZE = dict(batch=1, image=32, classes=10)
execute_mod = importlib.import_module("tf2_tpu_torch.graph.execute")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def squeeze():
    g = get_model("squeezenet_v1_1", **SQUEEZE)
    return g, init_params(g), np.ones(g.inputs["image"].shape, np.float32)


def _poisoned(params, name):
    bad = dict(params)
    bad[name] = np.asarray(params[name]) * np.nan
    return bad


def test_check_finite_clean(squeeze):
    g, params, x = squeeze
    assert check_finite(g, params, device="cpu", image=x) is None


@pytest.mark.parametrize("poison", ["fire5_squeeze.w", "conv1.w"])
def test_check_finite_localizes_nan_as_the_reference(squeeze, poison):
    """At or after the poisoned layer, never before it, and the node the
    reference's ``check_finite`` names on the same params and input."""
    g, _, x = squeeze
    rg = ref_get_model("squeezenet_v1_1", **SQUEEZE)
    ref_params = {k: np.array(v) for k, v in ref_init_params(rg).items()}
    first = check_finite(g, _poisoned(ref_params, poison), device="cpu", image=x)
    names = [n.name for n in g.nodes]
    assert first is not None
    assert names.index(first) >= names.index(poison.removesuffix(".w"))
    assert first == ref_check_finite(rg, _poisoned(ref_params, poison), image=jnp.asarray(x))


def test_compare_backends_identical_on_cpu():
    """On the CPU both runs are the plain versions: no finding."""
    g = get_model("squeezenet_v1_1", **SQUEEZE)
    batches = calibration_batches(g.inputs["image"].shape, 1, 0)
    art, _, _ = transform_model(g, init_params(g), batches, qspec=QuantSpec(), device="cpu")
    findings = compare_backends(art.graph, art.params, device="cpu",
                                image=batches[0]["image"])
    assert findings == []


def test_checked_execute_catches_nan(squeeze):
    g, params, x = squeeze
    fn = checked_execute(g, device="cpu")
    out = fn(params, image=x)
    assert tuple(out.shape) == (1, 10)
    torch.testing.assert_close(out, execute(g)({k: torch.as_tensor(v) for k, v in params.items()},
                                               image=torch.as_tensor(x)), rtol=0, atol=0)
    with pytest.raises(FloatingPointError, match="nan") as err:
        fn(_poisoned(params, "conv1.w"), image=x)
    assert "conv1" in str(err.value)
    with pytest.raises(FloatingPointError, match="fire5_squeeze.*nan"):
        fn(_poisoned(params, "fire5_squeeze.w"), image=x)


def test_checked_execute_catches_inf():
    """An f32 overflow is named ``inf`` (a NaN is named first where both
    are in one output)."""
    g = Graph("scale", {"x": TensorSpec((2, 3), "float32")}, ("y",),
              [Node("y", "mul", ("x", "x"), (), {})], {}, {})
    fn = checked_execute(g, device="cpu")
    assert torch.equal(fn({}, x=np.full((2, 3), 2.0, np.float32)),
                       torch.full((2, 3), 4.0))
    with pytest.raises(FloatingPointError, match="node y \\(mul\\): inf"):
        fn({}, x=np.full((2, 3), 3e38, np.float32))


def _qgelu_graph(dtype):
    return Graph("g", {"x": TensorSpec((4,), dtype)}, ("y",),
                 [Node("y", "qgelu", ("x",), (), {"s_in": 0.05, "s_out": 0.04})], {}, {})


def test_checked_execute_checks_the_gather_index():
    """The qgelu table has 256 entries: an int8 input always lies in it (the
    output equals the executor's); an index outside it raises IndexError
    before the gather."""
    x = np.array([-128, -1, 0, 127], np.int8)
    got = checked_execute(_qgelu_graph("int8"), device="cpu")({}, x=x)
    assert torch.equal(got, execute(_qgelu_graph("int8"))({}, x=torch.as_tensor(x)))
    with pytest.raises(IndexError, match="qgelu.*index out of range"):
        checked_execute(_qgelu_graph("int16"), device="cpu")(
            {}, x=np.array([0, 1, 300, 2], np.int16))


def test_debug_entry_points_default_to_the_card(squeeze):
    g, params, x = squeeze
    for call in (lambda: check_finite(g, params, image=x),
                 lambda: checked_execute(g),
                 lambda: compare_backends(g, params, image=x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.fixture
def plain_flags(monkeypatch):
    """Each executor of an op with a kernel records the ``kernel`` it gets."""
    seen = []
    for op, (impl, takes_kernel) in list(execute_mod._OP_IMPLS.items()):
        if takes_kernel:
            def rec(node, params, *args, kernel=None, _impl=impl):
                seen.append((node.name, kernel))
                return _impl(node, params, *args, kernel=kernel)
            monkeypatch.setitem(execute_mod._OP_IMPLS, op, (rec, True))
    return seen


def test_plain_mode_reaches_every_node(plain_flags):
    """Inside ``plain_mode`` every kernel node of an ``execute`` forward and
    of an Engine (block-fused, its fc on ``library``) takes its plain
    version; outside, none does; the outputs are the same."""
    art = synthetic_quantized("resnet50", seed=0, batch=2, image=64, depths=(1, 1, 1, 1),
                              classes=64)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    eng = Engine(art.graph, art.params, device="cpu")
    kernel_nodes = {n.name for n in eng.graph.nodes
                    if execute_mod._OP_IMPLS[n.op][1]}
    fc = frozenset({"fc"})
    fwd = execute(eng.graph, kernels=dict.fromkeys(fc, "library"))
    want = fwd(eng.params, image=torch.as_tensor(x))
    assert {name for name, k in plain_flags if k is None} == kernel_nodes - fc
    assert ("fc", "library") in plain_flags
    with plain_mode():
        plain_flags.clear()
        got = fwd(eng.params, image=torch.as_tensor(x))
        assert {name for name, _ in plain_flags} == kernel_nodes
        eng2 = Engine(art.graph, art.params, device="cpu")  # its load runs shapes on meta
        plain_flags.clear()
        logits = eng2.run(image=x)
        assert {name for name, _ in plain_flags} == kernel_nodes
    assert all(k == "plain" for _, k in plain_flags)
    assert torch.equal(got, want) and torch.equal(logits, eng.run(image=x))


def test_plain_mode_is_off_by_default_and_after_an_exception(plain_flags):
    assert execute_mod._PLAIN_MODE is False
    with pytest.raises(RuntimeError, match="inside"):
        with plain_mode():
            assert execute_mod._PLAIN_MODE is True
            with plain_mode():   # nested: the outer setting comes back
                pass
            assert execute_mod._PLAIN_MODE is True
            raise RuntimeError("inside")
    assert execute_mod._PLAIN_MODE is False
    art = synthetic_quantized("squeezenet_v1_1", seed=0, batch=1, image=32, classes=10)
    eng = Engine(art.graph, art.params, device="cpu")
    plain_flags.clear()   # the load's shapes run plain, on meta tensors
    eng.run(image=np.zeros((1, 32, 32, 3), np.float32))
    assert plain_flags and not any(k == "plain" for _, k in plain_flags)
