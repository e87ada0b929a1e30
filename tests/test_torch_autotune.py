"""The port's routing table (``kernels/autotune.py``) and the routes the
Engine resolves at load (``kernels/dispatch.py``), on the CPU against
tf2_tpu: the key strings on every conv and dense node of the five zoo
graphs, the speed-of-light floor and the rejection of impossible
timings, the table's path, the committed default, the order override >
table > default, and Engines routed through ``kernel``, ``kernel_int8``
and ``library`` against the unrouted Engine and the reference's Engine,
every int8 node equal (tolerance 0)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.ir import Graph as RefGraph
from tf2_tpu.graph.shapes import activation_shapes as ref_activation_shapes
from tf2_tpu.kernels import autotune as ref_autotune
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.graph.shapes import activation_shapes
from tf2_tpu_torch.kernels import autotune, dispatch
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import from_reference

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)
ZOO = {"resnet50": SMALL, "googlenet": dict(batch=2, image=64, classes=10),
       "squeezenet_v1_1": dict(batch=2, image=96, classes=10),
       "ssd": dict(batch=2, image=128, classes=21),
       "vit_b16": dict(batch=2, image=64, classes=10, dim=64, depth=2, heads=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def table(tmp_path):
    """An empty routing table in ``tmp_path``; the override off."""
    path = tmp_path / "routing.json"
    autotune.set_table_path(str(path))
    dispatch.set_use_kernels(None)
    yield path
    dispatch.set_use_kernels(None)
    autotune.set_table_path(None)


def _write(path, routes):
    path.write_text(json.dumps({"routes": routes, "detail": {}}))
    autotune.set_table_path(str(path))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_keys_equal_references_on_every_zoo_node(name):
    """conv_key and dense_key of every qconv2d and qdense node, each
    package on its own graph and its own shapes."""
    art = synthetic_quantized(name, seed=0, weight_bits=8 if name == "vit_b16" else 4,
                              **ZOO[name])
    shapes = activation_shapes(art.graph, art.params)
    rg = RefGraph.from_json(art.graph.to_json())
    ref_shapes = ref_activation_shapes(rg)
    n = 0
    for node, ref_node in zip(art.graph.nodes, rg.nodes):
        a, ra = node.attrs, ref_node.attrs
        if node.op == "qconv2d":
            got = autotune.conv_key(shapes[node.inputs[0]], a["kshape"], a.get("strides", [1, 1]),
                                    a.get("groups", 1), a["wfmt"])
            want = ref_autotune.conv_key(ref_shapes[ref_node.inputs[0]], ra["kshape"],
                                         ra.get("strides", [1, 1]), ra.get("groups", 1),
                                         ra["wfmt"])
        elif node.op == "qdense":
            got = autotune.dense_key(shapes[node.inputs[0]], a["kshape"], a["wfmt"])
            want = ref_autotune.dense_key(ref_shapes[ref_node.inputs[0]], ra["kshape"],
                                          ra["wfmt"])
        else:
            continue
        assert got == want
        n += 1
    assert n >= 2


def test_floor_is_the_h100_roofline():
    """bytes over 3.35 TB/s against 2 * MACs over 1,979 TOP/s."""
    key = "conv:b64:hw56x56:k3x3:ci64:co64:s11:g1:pot4"
    macs = 64 * 56 * 56 * 64 * 9 * 64
    byts = 64 * 56 * 56 * 64 + 9 * 64 * 64 * 0.5 + 64 * 56 * 56 * 64
    assert autotune.key_floor_s(key) == pytest.approx(max(byts / 3.35e12, 2 * macs / 1979e12))
    key = "dense:m64:k2048:n1000:int8"
    byts = 64 * 2048 + 2048 * 1000 + 64 * 1000
    assert autotune.key_floor_s(key) == pytest.approx(byts / 3.35e12)
    assert autotune.key_floor_s("attn:b64:t197:h12:d768") is None
    assert autotune.key_floor_s("lrn:m200704:c64") is None
    # the same formula as the reference's, on its own peaks
    assert ref_autotune.key_floor_s(key) == pytest.approx(
        max(byts / ref_autotune._PEAK_HBM_BPS, 2 * 64 * 2048 * 1000 / ref_autotune._PEAK_INT8_OPS))


def test_record_rejects_impossible_timings(table):
    key = "dense:m64:k2048:n1000:pot4"
    floor_ms = autotune.key_floor_s(key) * 1e3
    assert not autotune.plausible(key, floor_ms / 2)
    assert not autotune.plausible(key, None) and not autotune.plausible(key, float("inf"))
    assert autotune.plausible(key, floor_ms * 2)
    autotune.record(key, "library", {"library_ms": floor_ms / 10, "kernel_ms": 1.0})
    assert autotune.route(key) == "kernel" and "implausible" in autotune.detail(key)["rejected"]
    autotune.record(key, "kernel_int8", {"kernel_int8_ms": 1.0, "kernel_ms": floor_ms / 10})
    assert autotune.route(key) == "kernel"
    autotune.record(key, "kernel_int8", {"kernel_int8_ms": 0.5, "kernel_ms": 1.0})
    assert autotune.route(key) == "kernel_int8"
    autotune.save()
    saved = json.loads(table.read_text())
    assert saved["routes"] == {key: "kernel_int8"}


def test_table_path_and_its_environment_variable(monkeypatch, tmp_path):
    autotune.set_table_path(None)
    monkeypatch.setenv(autotune.TUNE_ENV, str(tmp_path))
    assert autotune.table_path() == str(tmp_path / f"routing_{autotune.platform()}.json")
    monkeypatch.delenv(autotune.TUNE_ENV)
    assert autotune.table_path().endswith(
        f"tf2_tpu_torch/kernels/tuned/routing_{autotune.platform()}.json")
    autotune.set_table_path(str(tmp_path / "x.json"))
    assert autotune.table_path() == str(tmp_path / "x.json")
    autotune.set_table_path(None)
    assert autotune.platform() == ("cpu" if not torch.cuda.is_available() else
                                   "sm%d%d" % torch.cuda.get_device_capability())
    gitignore = open(autotune.__file__.rsplit("tf2_tpu_torch", 1)[0] + ".gitignore").read()
    assert "tf2_tpu_torch/kernels/tuned/" in gitignore


def test_committed_default_loads(table, monkeypatch):
    """The H100 default: every route one of the exact routes; every entry
    off ``kernel`` names the card and its power limit and beat kernel.
    Loaded where the table has no routes."""
    path = autotune.default_path("sm90")
    with open(path) as f:
        committed = json.load(f)
    assert set(committed) == {"routes", "detail"}
    for key, r in committed["routes"].items():
        assert r in dispatch.ROUTES
        if r != "kernel":
            d = committed["detail"][key]
            assert "H100" in d["card"] and " W" in d["card"]
            assert d[f"{r}_ms"] * d["margin"] < d["kernel_ms"]
    monkeypatch.setattr(autotune, "platform", lambda: "sm90")
    autotune.set_table_path(str(table))
    assert autotune._load()["routes"] == committed["routes"]


def test_override_beats_table_beats_default(table):
    gemm = ((64, 56, 56, 64), (1, 1, 64, 256), (1, 1), 1, "pot4")
    conv = ((64, 56, 56, 64), (3, 3, 64, 64), (1, 1), 1, "pot4")
    stem = ((64, 224, 224, 3), (7, 7, 3, 64), (2, 2), 1, "int8")
    dense = ((64, 2048), (2048, 1000), "int8")
    assert dispatch.route_conv(*gemm) == "kernel" and dispatch.route_dense(*dense) == "kernel"
    _write(table, {autotune.conv_key(*gemm): "library", autotune.conv_key(*conv): "library",
                   autotune.conv_key(*stem): "kernel_int8",
                   autotune.dense_key(*dense): "library"})
    assert dispatch.route_conv(*gemm) == "library"
    assert dispatch.route_dense(*dense) == "library"
    # a route the node does not have is no route
    assert dispatch.route_conv(*conv) == "kernel" and dispatch.route_conv(*stem) == "kernel"
    dispatch.set_use_kernels(True)
    assert dispatch.route_conv(*gemm) == "kernel" and dispatch.route_dense(*dense) == "kernel"
    dispatch.set_use_kernels(False)
    assert dispatch.route_conv(*gemm) == "library" and dispatch.route_conv(*conv) == "kernel"
    assert dispatch.route_dense(*dense) == "library"
    assert dispatch.conv_choices((3, 3, 64, 64), (1, 1), "SAME", 1, "pot4") == (
        "kernel", "kernel_int8")
    assert dispatch.conv_choices((3, 3, 64, 64), (1, 1), "SAME", 2, "pot4") == ("kernel",)
    assert dispatch.conv_choices((1, 1, 64, 64), (1, 1), "SAME", 1, "pot4") == dispatch.ROUTES


@pytest.mark.parametrize("m,k,n,relu,resid", [(1, 64, 16, True, False), (40, 60, 20, False, True),
                                              (17, 16, 8, True, True), (130, 2048, 1000, True,
                                                                        False)])
def test_library_matmul_equals_the_int8_gemm(m, k, n, relu, resid):
    """``torch._int_mm`` with the padding it needs (M > 16, K and N
    multiples of 8) and the f32 epilogue: the plain int8 GEMM's bits."""
    from tf2_tpu_torch.kernels import shift_matmul

    rng = np.random.default_rng(m + k + n)
    x = torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8))
    es = torch.as_tensor(rng.uniform(1e-5, 1e-3, n).astype(np.float32))
    eb = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    r = (torch.as_tensor(rng.integers(-127, 128, (m, n), dtype=np.int8)), 0.37) if resid else None
    want = shift_matmul.qmatmul_int8_plain(x, w, es, eb, relu, r)
    assert torch.equal(dispatch.library_matmul(x, w, es, eb, relu, r), want)
    wk = shift_matmul.prepare_weight(w)  # the Engine's K-major view
    assert torch.equal(dispatch.library_matmul(x, wk, es, eb, relu, r), want)


@pytest.fixture(scope="module")
def case():
    g = ref_get_model("resnet50", **SMALL)
    fg, fp = ref_fold(g, {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()})
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    art = ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=4, pot_candidates=5))
    ref = RefEngine(art.graph, art.params, phase_stem=False)
    _, env = jax.jit(ref_execute(ref.graph, intermediates=True))(ref.params, image=jnp.asarray(x))
    return dict(art=art, x=x, ref_env={k: np.asarray(v) for k, v in env.items()})


def _every_key(graph, params, route):
    """A table sending every conv and dense key that has ``route`` to it."""
    shapes = activation_shapes(graph, params)
    routes = {}
    for n in graph.nodes:
        a = n.attrs
        if n.op == "qconv2d":
            key = autotune.conv_key(shapes[n.inputs[0]], a["kshape"], a.get("strides", [1, 1]),
                                    a.get("groups", 1), a["wfmt"])
            choices = dispatch.conv_choices(a["kshape"], a.get("strides", [1, 1]),
                                            a.get("padding", "SAME"), a.get("groups", 1),
                                            a["wfmt"])
        elif n.op == "qdense":
            key = autotune.dense_key(shapes[n.inputs[0]], a["kshape"], a["wfmt"])
            choices = dispatch.dense_choices(a["wfmt"])
        else:
            continue
        if route in choices:
            routes[key] = route
    return routes


@pytest.mark.parametrize("route", ["kernel", "kernel_int8", "library", "forced_off"])
def test_routed_engine_equals_unrouted_and_reference(case, table, route):
    """Every node its route has sent to ``route`` (``forced_off``:
    ``set_use_kernels(False)``): the Engine's routes as asked, its graph
    the unrouted one's with the routed pot4 nodes decoded, every int8 node
    equal to the unrouted Engine's and to the reference Engine's."""
    g, p = from_reference(case["art"].graph.to_json(), case["art"].params)
    x = torch.as_tensor(case["x"])
    base = Engine(g, p, device="cpu", block_fusion=False)
    _, base_env = execute(base.graph, intermediates=True)(base.params, image=x)
    if route == "forced_off":
        dispatch.set_use_kernels(False)
    else:
        _write(table, _every_key(g, p, route))
    eng = Engine(g, p, device="cpu", block_fusion=False)
    dispatch.set_use_kernels(None)
    if route == "kernel":
        assert eng.routes == {} and eng.graph.to_json() == base.graph.to_json()
    else:
        want = "library" if route == "forced_off" else route
        assert eng.routes and set(eng.routes.values()) == {want}
        assert (eng.library_nodes == frozenset(eng.routes)) == (want == "library")
        pot4 = {n.name for n in eng.graph.nodes if n.attrs.get("wfmt") == "pot4"}
        assert not pot4 & set(eng.routes)
    out, env = execute(eng.graph, intermediates=True, kernels=eng.kernels)(eng.params, image=x)
    int8 = [n.name for n in eng.graph.nodes if env[n.name].dtype == torch.int8]
    assert len(int8) == 24
    for name in int8:
        assert torch.equal(env[name], base_env[name]), name
        np.testing.assert_array_equal(env[name].numpy(), case["ref_env"][name], err_msg=name)
    assert torch.equal(eng.run(image=x), out)
