"""The rank program of a meshed run (``parallel.launch.spawn(
"tf2_tpu_torch.bench.mesh_worker:run", n, args=[config])``): every rank
loads one artifact and runs, for each mesh the config lists, the meshed
Engine on its part of one global batch, then, as asked, the lockstep
``MultiHostEngine`` on both data planes and the tp matmuls. Rank 0 writes
what the parent compares; every rank writes its own findings.

The config (JSON): ``out`` (a directory), ``device``; for the meshes and
the lockstep steps ``artifact`` (a directory) and ``inputs`` (an ``.npz``
with ``image``, the global batch);
``meshes``, each ``{"label", "tp", "flags": Engine options, "expected":
launches a forward with every node on kernel, or null}``;
``check_shardings`` (``utils.debug.compare_shardings`` on every mesh
against the unmeshed Engine of the same options: atol 0, every element
exact); ``save_env`` (rank 0 keeps every int8 value, gathered);
``timed`` (``[iters, reps]``: ``Engine.benchmark`` of each meshed
forward, eager); ``multihost`` (``{"tp": n}``, optionally
``"throughput": steps``: the lockstep ``MultiHostEngine`` on both planes,
``_multihost``); ``pin_cores`` (on the CPU, each rank on its share of
the cores, as ``bench/multihost_sim.py`` runs); ``matmul`` (an ``.npz``
of operands: ``allgather_matmul``, ``gspmd_matmul`` and the psum
primitive over the whole world, ``_matmul``).

Outputs: ``rank{r}.json`` per rank (plain nodes, launch counts, findings,
ms, the lockstep steps and img/s); from rank 0 ``{label}.npz``
(``logits``, the gathered output, and with ``save_env`` every int8 value,
a tp rank's residual slices included), ``multihost.npz`` and
``matmul.npz``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist


def _meshed(graph, params, x, spec, cfg, out_dir, rank, whole_cache):
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.parallel import make_mesh
    from tf2_tpu_torch.parallel.mesh import all_gather_last, gather_batch
    from tf2_tpu_torch.runtime import Engine
    from tf2_tpu_torch.utils.debug import compare_shardings

    device, flags = cfg["device"], spec.get("flags", {})
    mesh = make_mesh(tp=spec["tp"])
    eng = Engine(graph, params, device=device, mesh=mesh, **flags)
    if device == "cuda" and eng.plain_nodes:
        raise RuntimeError(f"{spec['label']} rank {rank}: nodes no kernel takes: "
                           f"{sorted(eng.plain_nodes)}")
    local = eng.shard_inputs(image=x)["image"]
    kernels.reset_launch_counts()
    out = eng.run(image=local)
    counts = kernels.launch_counts()
    if spec.get("expected") is not None:
        want = eng.expected_launches(spec["expected"], graph)
        if counts != want:
            raise RuntimeError(f"{spec['label']} rank {rank}: launches {counts}, expected {want}")
    logits = eng.gather(out)
    result = {"label": spec["label"], "dp": mesh.dp, "tp": mesh.tp, "rows": eng.rows,
              "tp_nodes": len(eng.tp_nodes), "plain_nodes": sorted(eng.plain_nodes),
              "launches": counts, "local_shape": list(out.shape)}
    saved = {"logits": logits.cpu().numpy()}
    if cfg.get("save_env"):
        _, env = execute(eng.graph, intermediates=True, kernels=eng.kernels,
                         gather_nodes=eng.tp_nodes,
                         gather=lambda t: all_gather_last(mesh, t))(
            eng.params, image=torch.as_tensor(local).to(eng.device))
        for node in eng.graph.nodes:
            if env[node.name].dtype == torch.int8:
                v = env[node.name] if eng.rows is None else gather_batch(mesh, env[node.name])
                saved[node.name] = v.cpu().numpy()
    if cfg.get("check_shardings"):
        key = json.dumps(flags, sort_keys=True)
        if key not in whole_cache:
            whole_cache[key] = Engine(graph, params, device=device, **flags)
        result["findings"] = compare_shardings(eng, whole_cache[key], image=x)
        if result["findings"]:
            raise RuntimeError(f"{spec['label']} rank {rank}: nodes differ from their part of "
                               f"the unmeshed Engine's: {result['findings'][:3]}")
    if cfg.get("timed") and device == "cuda":
        iters, reps = cfg["timed"]
        result["ms_per_forward"] = eng.benchmark(iters=iters, reps=reps,
                                                 image=local)["latency_s"] * 1e3
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{spec['label']}.npz"), **saved)
    return result


def _multihost(graph, params, x, cfg, out_dir, rank):
    """The lockstep protocol (the counterpart of the reference's
    ``tests/dist/mh_worker.py``): the coordinator drives two
    coordinator-fed steps (the batch, then the batch reversed), a
    shard-local step with and without the gather and, with
    ``throughput: n``, ``measure_throughput`` of each plane over n steps,
    while the other ranks follow (``worker_loop``, fed their rows of the
    batch). Rank 0 writes ``multihost.npz``."""
    from tf2_tpu_torch.parallel import make_mesh
    from tf2_tpu_torch.serve.multihost import MultiHostEngine

    spec = cfg["multihost"]
    mh = MultiHostEngine(graph, params, mesh=make_mesh(tp=spec["tp"]), device=cfg["device"])
    lo = mh.engine.rows[0] if mh.engine.rows is not None else 0
    rows = x[lo:lo + mh.local_batch]
    report = {"local_batch": mh.local_batch, "global_batch": mh.global_batch}
    if not mh.is_coordinator:
        report["steps"] = mh.worker_loop(feed=lambda seq, n: x[lo:lo + n])
        return report
    saved = {"global_plane": mh.step(x), "global_plane_reversed": mh.step(x[::-1]),
             "local_plane": mh.step(local_rows=rows),
             "own_rows": mh.step(local_rows=rows, gather=False)}
    report["steps"] = len(saved)
    if spec.get("throughput"):
        n = spec["throughput"]
        report["img_s"] = mh.measure_throughput(n_steps=n)
        report["img_s_local"] = mh.measure_throughput(n_steps=n, shard_local=True)
        report["steps"] += 2 * (n + 1)
    mh.shutdown()
    np.savez(os.path.join(out_dir, "multihost.npz"), **saved)
    return report


def _matmul(cfg, out_dir, rank):
    """The tp matmuls over the whole world on the operands of
    ``cfg["matmul"]`` (an ``.npz`` of ``y_<kind>``, ``w_<kind>`` pairs, kind
    ``f32`` or ``int8``): this rank's K-chunk of y, w replicated. Rank 0
    writes ``matmul.npz``: ``ring_<kind>``, ``gspmd_<kind>`` and, for f32,
    ``psum_f32`` (the contracting-dim-sharded product, x_chunk @ w_rows
    summed over the ranks under gloo: the tp primitive of the reference's
    ``tests/dist/test_mesh.py:90-106``)."""
    from tf2_tpu_torch.parallel import make_mesh
    from tf2_tpu_torch.parallel.tp_overlap import allgather_matmul, gspmd_matmul

    mesh = make_mesh(tp=dist.get_world_size() if dist.is_initialized() else 1)
    dev = torch.device(cfg["device"])
    data = np.load(cfg["matmul"])
    out = {}
    for kind, acc in (("f32", torch.float32), ("int8", torch.int32)):
        if f"y_{kind}" not in data:
            continue
        y, w = (torch.as_tensor(data[f"{v}_{kind}"]).to(dev) for v in ("y", "w"))
        kc = y.shape[1] // mesh.tp
        rows = slice(mesh.tp_index * kc, (mesh.tp_index + 1) * kc)
        y_local = y[:, rows].contiguous()
        out[f"ring_{kind}"] = allgather_matmul(mesh, y_local, w, acc).cpu().numpy()
        out[f"gspmd_{kind}"] = gspmd_matmul(mesh, y_local, w, acc).cpu().numpy()
        if kind == "f32" and dist.is_initialized() and dist.get_backend() == "gloo":
            part = torch.matmul(y_local, w[rows]).cpu()  # gloo sums on the host
            dist.all_reduce(part)
            out["psum_f32"] = part.numpy()
    if rank == 0:
        np.savez(os.path.join(out_dir, "matmul.npz"), **out)
    return {"tp": mesh.tp, "kinds": sorted(out)}


def _pin(rank: int, nproc: int) -> None:
    """Each simulated host on its own cores (one rank alone on half of
    them, one host's share): without this the one- and two-process runs
    share cores and a throughput reads contention."""
    cores = sorted(os.sched_getaffinity(0))
    if nproc > 1 and len(cores) >= nproc:
        per = len(cores) // nproc
        os.sched_setaffinity(0, set(cores[rank * per:(rank + 1) * per]))
    elif nproc == 1 and len(cores) > 1:
        os.sched_setaffinity(0, set(cores[:max(1, len(cores) // 2)]))


def run(config_path: str) -> None:
    from tf2_tpu_torch.transform import load_artifact

    with open(config_path) as f:
        cfg = json.load(f)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if cfg["device"] == "cpu":
        torch.set_num_threads(1)
        if cfg.get("pin_cores"):
            _pin(rank, dist.get_world_size() if dist.is_initialized() else 1)
    out_dir = cfg["out"]
    report = {"rank": rank, "backend": dist.get_backend() if dist.is_initialized() else None,
              "device": (torch.cuda.get_device_name() if cfg["device"] == "cuda" else "cpu"),
              "meshes": []}
    whole_cache = {}
    if cfg.get("meshes") or cfg.get("multihost"):
        graph, params = load_artifact(cfg["artifact"])
        x = np.load(cfg["inputs"])["image"]
    for spec in cfg.get("meshes", []):
        report["meshes"].append(_meshed(graph, params, x, spec, cfg, out_dir, rank, whole_cache))
        print(json.dumps(report["meshes"][-1]), flush=True)
    if cfg.get("multihost"):
        report["multihost"] = _multihost(graph, params, x, cfg, out_dir, rank)
    if cfg.get("matmul"):
        report["matmul"] = _matmul(cfg, out_dir, rank)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
