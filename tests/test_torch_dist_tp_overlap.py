"""The port's ring-overlapped tp matmul against the reference's
tests/dist/test_tp_overlap.py, on the CPU in gloo worlds of 2 and 4
processes (``bench/mesh_worker.py``): ``allgather_matmul`` and
``gspmd_matmul`` against the dense product and the reference's
``allgather_matmul`` on the same numpy operands (f32 within the reference
test's rtol 1e-5 / atol 1e-4, int8 bit for bit), the contracting-dim psum
primitive (tests/dist/test_mesh.py:90-106, within its 1e-3), and a tiny
W8 ViT at tp 2 whose every int8 value, attention and layer norm
replicated, equals the unmeshed Engine's (compare_shardings at atol 0)."""
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.parallel import make_mesh as ref_make_mesh
from tf2_tpu.parallel.tp_overlap import allgather_matmul as ref_allgather_matmul
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.parallel.launch import spawn
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import save_artifact

VIT_TINY = dict(batch=2, image=64, classes=10, dim=64, depth=2, heads=4)
WORLDS = (2, 4)
SPAWN_S = 240


def _operands():
    """The reference tests' shapes: f32 (32, 128) x (128, 64), int8
    (16, 64) x (64, 32); the psum's (16, 256) x (256, 64)."""
    rng = np.random.default_rng(0)
    return {"y_f32": rng.standard_normal((32, 128), dtype=np.float32),
            "w_f32": rng.standard_normal((128, 64), dtype=np.float32),
            "y_int8": rng.integers(-100, 100, (16, 64), dtype=np.int8),
            "w_int8": rng.integers(-100, 100, (64, 32), dtype=np.int8)}


def _run_world(d, name, world, ops, vit: bool) -> dict:
    out = d / name
    out.mkdir()
    np.savez(out / "ops.npz", **ops)
    cfg = {"out": str(out), "device": "cpu", "matmul": str(out / "ops.npz")}
    if vit:
        cfg.update(artifact=str(d / "vit"), inputs=str(d / "x.npz"), save_env=True,
                   check_shardings=True, meshes=[{"label": "vit_tp2", "tp": 2, "flags": {}}])
    (out / "cfg.json").write_text(json.dumps(cfg))
    spawn("tf2_tpu_torch.bench.mesh_worker:run", world, backend="gloo", device="cpu",
          args=[str(out / "cfg.json")], timeout_s=SPAWN_S, env={"OMP_NUM_THREADS": "1"})
    res = {"matmul": dict(np.load(out / "matmul.npz")),
           "reports": [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]}
    if vit:
        res["vit"] = dict(np.load(out / "vit_tp2.npz"))
    return res


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    art = synthetic_quantized("vit_b16", weight_bits=8, **VIT_TINY)
    save_artifact(str(d / "vit"), art.graph, art.params)
    x = np.random.default_rng(1).standard_normal(art.graph.inputs["image"].shape,
                                                 dtype=np.float32)
    np.savez(d / "x.npz", image=x)
    ops = _operands()
    psum_ops = {"y_f32": np.random.default_rng(2).standard_normal((16, 256), dtype=np.float32),
                "w_f32": np.random.default_rng(3).standard_normal((256, 64), dtype=np.float32)}
    with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        worlds = {w: pool.submit(_run_world, d, f"world{w}", w, ops, vit=(w == 2))
                  for w in WORLDS}
        psum = pool.submit(_run_world, d, "psum", 4, psum_ops, vit=False)
        eng = Engine(art.graph, art.params, device="cpu")
        _, env = execute(eng.graph, intermediates=True)(eng.params, image=torch.as_tensor(x))
        whole = {k: v.numpy() for k, v in env.items()}
        return dict(ops=ops, psum_ops=psum_ops, whole=whole, out=eng.graph.outputs[0],
                    worlds={w: f.result() for w, f in worlds.items()}, psum=psum.result())


@pytest.mark.parametrize("tp", WORLDS)
def test_ring_allgather_matmul_parity_f32(case, tp):
    ops, got = case["ops"], case["worlds"][tp]["matmul"]
    dense = ops["y_f32"] @ ops["w_f32"]
    cfg = ref_make_mesh(tp=tp)
    y_sh = jax.device_put(jnp.asarray(ops["y_f32"]), cfg.named(None, cfg.tp_axis))
    ref = np.asarray(ref_allgather_matmul(cfg, y_sh, jnp.asarray(ops["w_f32"])))
    for name in ("ring_f32", "gspmd_f32"):
        np.testing.assert_allclose(got[name], dense, rtol=1e-5, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(got[name], ref, rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("tp", WORLDS)
def test_ring_allgather_matmul_int8(case, tp):
    """int8 operands, int32 accumulation: bit for bit against the dense
    product and the reference's ring."""
    ops, got = case["ops"], case["worlds"][tp]["matmul"]
    dense = ops["y_int8"].astype(np.int32) @ ops["w_int8"].astype(np.int32)
    cfg = ref_make_mesh(tp=tp)
    y_sh = jax.device_put(jnp.asarray(ops["y_int8"]), cfg.named(None, cfg.tp_axis))
    ref = np.asarray(ref_allgather_matmul(cfg, y_sh, jnp.asarray(ops["w_int8"]),
                                          acc_dtype=jnp.int32))
    np.testing.assert_array_equal(ref, dense)
    for name in ("ring_int8", "gspmd_int8"):
        assert got[name].dtype == np.int32
        np.testing.assert_array_equal(got[name], dense, err_msg=name)


def test_psum_channel_sharded_matmul(case):
    """Each rank's K-chunk of x times its rows of w, summed over the ranks
    (an all-reduce), equals the dense product."""
    ops = case["psum_ops"]
    np.testing.assert_allclose(case["psum"]["matmul"]["psum_f32"], ops["y_f32"] @ ops["w_f32"],
                               atol=1e-3, rtol=1e-3)


def test_vit_tp2_logits_equal_unmeshed(case):
    vit = case["worlds"][2]["vit"]
    np.testing.assert_array_equal(vit["logits"], case["whole"][case["out"]])


def test_vit_tp2_every_int8_node_exact(case):
    """Every int8 value of the tp-2 ViT (the qkv, projection and MLP
    GEMMs sliced, the folded residuals read through their slices;
    attention, layer norm and gelu whole on each rank) equals the unmeshed
    Engine's; compare_shardings finds nothing on either rank."""
    vit, whole = case["worlds"][2]["vit"], case["whole"]
    int8 = [k for k, v in whole.items() if v.dtype == np.int8 and k != "image"]
    assert len(int8) >= 20
    for k in int8:
        np.testing.assert_array_equal(vit[k], whole[k], err_msg=k)
    assert any(k.endswith("__tp_residual") for k in vit)
    for rep in case["worlds"][2]["reports"]:
        (mesh,) = rep["meshes"]
        assert mesh["findings"] == [] and mesh["tp_nodes"] >= 10


def test_tp_overlap_bench_line_on_the_cpu(tmp_path):
    """The bench's own line at the reference bench's shape on two gloo
    ranks (each rank checks both products against the dense one first)."""
    from tf2_tpu_torch.bench import tp_overlap_bench

    line = tp_overlap_bench.measure(world=2, device="cpu", iters=1, reps=1)
    assert line["shape"] == "(512,2048)x(2048,1024), K sharded tp=2"
    assert len(line["per_rank"]) == 2 and "not a link's overlap" in line["note"]
    for kind in ("f32", "int8"):
        assert line["rank0"][f"{kind}_ring_ms"] > 0 and line["rank0"][f"{kind}_gspmd_ms"] > 0
