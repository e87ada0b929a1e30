"""The port's (dp, tp) mesh against the reference's tests/dist/test_mesh.py,
on the CPU: mesh shapes, the sharding specs against the reference's on its
8-device CPU mesh at tp 1, 2, 4 and 8, and the meshed Engine in gloo worlds
of 2 and 4 processes (``parallel.launch``; ``bench/mesh_worker.py``) at tp
1, 2 and 4 and dp 2 and 4, default (chains fused, replicated) and with
``block_fusion=False`` (every conv sharded), on the reference's small
ResNet-50 (batch 8, 32x32, depths 1-1-1-1, 16 classes, scales from the
reference's calibration). Tolerance 0: the gathered logits and every int8
value equal ``Engine(device="cpu")`` and the reference's ``execute`` on the
same numpy inputs, and ``compare_shardings`` finds no node off by any
quantum. The fp32 SqueezeNet under dp within the reference's 1e-4."""
import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.parallel import input_shardings as ref_input_shardings
from tf2_tpu.parallel import make_mesh as ref_make_mesh
from tf2_tpu.parallel import param_shardings as ref_param_shardings
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.graph.init_params import init_params
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.parallel import MeshConfig, input_shardings, make_mesh, param_shardings
from tf2_tpu_torch.parallel.launch import spawn
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import from_reference, save_artifact

SMALL = dict(batch=8, image=32, depths=(1, 1, 1, 1), classes=16)
VIT_TINY = dict(batch=2, image=64, classes=10, dim=64, depth=2, heads=4)
UNFUSED = {"block_fusion": False}
# world -> meshes: (label, tp, Engine options)
WORLDS = {4: [("tp4", 4, {}), ("tp4_unfused", 4, UNFUSED), ("tp2_dp2", 2, {}),
              ("tp2_dp2_unfused", 2, UNFUSED), ("dp4", 1, {})],
          2: [("tp2", 2, {}), ("tp2_unfused", 2, UNFUSED), ("dp2", 1, {}),
              ("dp2_unfused", 1, UNFUSED)]}
CASES = [(world, label) for world, meshes in WORLDS.items() for label, _, _ in meshes]
SPAWN_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_artifact():
    """The reference's small ResNet-50: calibrated on one seeded batch, W4."""
    g = ref_get_model("resnet50", **SMALL)
    fg, fp = ref_fold(g, {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()})
    x = np.random.default_rng(3).standard_normal(g.inputs["image"].shape).astype(np.float32)
    scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    return ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=4, pot_candidates=5)), x


def _run_world(d, world, meshes) -> dict:
    """One gloo world of ``world`` processes running every mesh of
    ``meshes`` on the saved artifact; -> {(world, label): result}."""
    out = d / f"world{world}"
    out.mkdir()
    cfg = {"artifact": str(d / "art"), "inputs": str(d / "x.npz"), "out": str(out),
           "device": "cpu", "save_env": True, "check_shardings": True,
           "meshes": [{"label": label, "tp": tp, "flags": flags} for label, tp, flags in meshes]}
    (out / "cfg.json").write_text(json.dumps(cfg))
    spawn("tf2_tpu_torch.bench.mesh_worker:run", world, backend="gloo", device="cpu",
          args=[str(out / "cfg.json")], timeout_s=SPAWN_S, env={"OMP_NUM_THREADS": "1"})
    reports = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    return {(world, label): dict(tp=tp, flags=flags, reports=[rep["meshes"][i] for rep in reports],
                                 saved=dict(np.load(out / f"{label}.npz")))
            for i, (label, tp, flags) in enumerate(meshes)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The worlds run in the background while this process computes the
    unmeshed port Engines' and the reference's values."""
    art, x = _ref_artifact()
    g, p = from_reference(art.graph.to_json(), art.params)
    d = tmp_path_factory.mktemp("mesh")
    save_artifact(str(d / "art"), g, p)
    np.savez(d / "x.npz", image=x)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        worlds = [pool.submit(_run_world, d, world, meshes) for world, meshes in WORLDS.items()]
        whole, ref_env = {}, {}
        for flags in ({}, UNFUSED):
            eng = Engine(g, p, device="cpu", **flags)
            _, env = execute(eng.graph, intermediates=True)(eng.params, image=torch.as_tensor(x))
            whole[json.dumps(flags)] = {k: v.numpy() for k, v in env.items()}
            # the reference's Engine with the port's options: its graph, executed
            # op by op (jit may contract an epilogue's multiply-add)
            ref = RefEngine(art.graph, art.params, block_fusion=flags.get("block_fusion", True),
                            phase_stem=False, merge_1x1=False)
            _, env = ref_execute(ref.graph, intermediates=True)(ref.params, image=jnp.asarray(x))
            ref_env[json.dumps(flags)] = {k: np.asarray(v) for k, v in env.items()}
        results = {}
        for f in worlds:
            results.update(f.result())
    return dict(art=art, g=g, p=p, x=x, ref_env=ref_env, whole=whole, results=results)


def test_mesh_shapes():
    cfg = make_mesh(tp=2, world=8)
    assert (cfg.dp, cfg.tp) == (4, 2)
    cfg = make_mesh(tp=8, world=8)
    assert (cfg.dp, cfg.tp) == (1, 8)
    with pytest.raises(ValueError):
        make_mesh(tp=3, world=8)
    cfg = make_mesh()   # no process group: one rank
    assert (cfg.dp, cfg.tp, cfg.rank, cfg.dp_group, cfg.tp_group) == (1, 1, 0, None, None)
    # the row-major (dp, tp) grid of the reference's make_mesh
    grid = [(MeshConfig(4, 2, r).dp_index, MeshConfig(4, 2, r).tp_index) for r in range(8)]
    assert grid == [(d, t) for d in range(4) for t in range(2)]


def _spec_graphs():
    return {"resnet50": (ref_get_model("resnet50", **SMALL), get_model("resnet50", **SMALL)),
            "vit_b16": (ref_get_model("vit_b16", **VIT_TINY), get_model("vit_b16", **VIT_TINY))}


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_param_and_input_shardings_equal_reference_quantized(case, tp):
    """Every param and input of the quantized ResNet (packed pot4 .wp,
    int8 .wq, es, eb) gets the reference's PartitionSpec entries."""
    ref_cfg = ref_make_mesh(tp=tp)
    cfg = make_mesh(tp=tp, world=8)
    ref_p = ref_param_shardings(case["art"].graph, ref_cfg)
    got = param_shardings(case["g"], cfg)
    assert got == {k: tuple(v.spec) for k, v in ref_p.items()}
    assert input_shardings(case["g"], cfg) == {
        k: tuple(v.spec) for k, v in ref_input_shardings(case["art"].graph, ref_cfg).items()}
    if tp > 1:   # the reference test's own check: a pot4 weight and an es split on tp
        assert got[next(k for k in got if k.endswith(".wp"))][-1] == "tp"
        assert got[next(k for k in got if k.endswith(".es"))][-1] == "tp"


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["resnet50", "vit_b16"])
def test_param_and_input_shardings_equal_reference_f32(model, tp):
    """The f32 graphs: .w, .b, the batch norms' and layer norms' vectors,
    the position embedding (replicated), an input batch dp does not
    divide (ViT's 2 at dp 8: replicated)."""
    ref_g, g = _spec_graphs()[model]
    ref_cfg, cfg = ref_make_mesh(tp=tp), make_mesh(tp=tp, world=8)
    assert param_shardings(g, cfg) == {
        k: tuple(v.spec) for k, v in ref_param_shardings(ref_g, ref_cfg).items()}
    assert input_shardings(g, cfg) == {
        k: tuple(v.spec) for k, v in ref_input_shardings(ref_g, ref_cfg).items()}


@pytest.mark.parametrize("world,label", CASES, ids=[f"w{w}-{lab}" for w, lab in CASES])
def test_meshed_engine_equals_unmeshed_and_reference(case, world, label):
    """The gathered logits and every int8 value of each rank's meshed
    Engine (gloo world) equal the unmeshed port Engine's and, at every node
    both graphs have, the reference's execute of its Engine's graph with
    the same options (chains fused or not; no stem or 1x1 rewrite);
    compare_shardings (teacher forced, atol 0) finds nothing on any rank."""
    res = case["results"][world, label]
    whole = case["whole"][json.dumps(res["flags"])]
    saved = res["saved"]
    out_name = case["g"].outputs[0]
    np.testing.assert_array_equal(saved["logits"], whole[out_name])
    int8 = [k for k, v in whole.items() if v.dtype == np.int8 and k != "image"]
    assert int8 and set(int8) <= set(saved)
    for k in int8:
        np.testing.assert_array_equal(saved[k], whole[k], err_msg=k)
    ref_env = case["ref_env"][json.dumps(res["flags"])]
    common = [k for k in int8 if k in ref_env]
    assert len(common) >= 15
    for k in common:
        np.testing.assert_array_equal(saved[k], ref_env[k], err_msg=k)
    np.testing.assert_array_equal(saved["logits"], ref_env[out_name])
    dp = world // res["tp"]
    for r, rep in enumerate(res["reports"]):
        assert rep["findings"] == [] and (rep["dp"], rep["tp"]) == (dp, res["tp"])
        assert (rep["tp_nodes"] > 0) == (res["tp"] > 1)
        per = SMALL["batch"] // dp
        assert rep["rows"] == (None if dp == 1 else [r // res["tp"] * per,
                                                      (r // res["tp"] + 1) * per])
        assert rep["local_shape"] == [per, SMALL["classes"]]


def test_tp_nodes_are_the_ungrouped_convs_and_dense(case):
    """Under tp 2 with block_fusion=False every conv and the fc is sliced
    (its params cut to half the output channels) and nothing else; the
    default Engine's chains stay whole."""
    cfg = MeshConfig(dp=1, tp=2, rank=1)
    unfused = Engine(case["g"], case["p"], device="cpu", mesh=cfg, block_fusion=False)
    qnodes = {n.name for n in unfused.graph.nodes if n.op in ("qconv2d", "qdense")}
    assert unfused.tp_nodes == qnodes and len(qnodes) == 18
    for n in unfused.graph.nodes:
        if n.name in unfused.tp_nodes:
            whole = case["g"].params[n.params[0]].shape[-1]
            assert n.attrs["kshape"][-1] == whole // 2
            assert all(unfused.params[p].shape[-1] == whole // 2 for p in n.params)
    fused = Engine(case["g"], case["p"], device="cpu", mesh=cfg)
    chains = [n for n in fused.graph.nodes if n.op == "qblockchain"]
    assert chains and not {n.name for n in chains} & fused.tp_nodes


def test_dp_rows_and_replicated_batch(case):
    """dp splits a batch it divides into each rank's rows (a call returns
    them) and replicates one it does not: every rank then runs the whole
    batch, as the reference replicates it, and gather returns it as is."""
    x = case["x"]
    want = case["whole"][json.dumps({})][case["g"].outputs[0]]
    for r in range(4):
        eng = Engine(case["g"], case["p"], device="cpu", mesh=MeshConfig(dp=4, tp=1, rank=r))
        assert eng.rows == (2 * r, 2 * r + 2)
        local = eng.shard_inputs(image=x)["image"]
        np.testing.assert_array_equal(local, x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(eng.run(image=local).numpy(), want[2 * r:2 * r + 2])
    g6, x6 = case["g"].with_batch_size(6), x[:6]
    whole6 = Engine(g6, case["p"], device="cpu").run(image=x6)
    eng = Engine(g6, case["p"], device="cpu", mesh=MeshConfig(dp=4, tp=1, rank=3))
    assert eng.rows is None and eng.shard_inputs(image=x6)["image"] is x6
    assert torch.equal(eng.gather(eng.run(image=x6)), whole6)


def test_engine_fp32_dp():
    """The reference's fp32 SqueezeNet under dp (tests/dist/test_mesh.py:
    80-87): each rank's rows, concatenated, within 1e-4 of the
    reference's execute."""
    g = get_model("squeezenet_v1_1", batch=8, image=32, classes=10)
    params = {k: np.asarray(v) for k, v in init_params(g, seed=1).items()}
    x = np.random.default_rng(5).standard_normal(g.inputs["image"].shape).astype(np.float32)
    rg = ref_get_model("squeezenet_v1_1", batch=8, image=32, classes=10)
    ref = np.asarray(ref_execute(rg)({k: jnp.asarray(v) for k, v in params.items()},
                                     image=jnp.asarray(x)))
    rows = []
    for r in range(2):
        eng = Engine(g, params, device="cpu", mesh=MeshConfig(dp=2, tp=1, rank=r))
        rows.append(eng.run(**eng.shard_inputs(image=x)).numpy())
    out = np.concatenate(rows)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
