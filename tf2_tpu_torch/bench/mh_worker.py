"""The failure rank program of the lockstep serving protocol
(``serve/multihost.py``), the counterpart of the reference's
``tests/dist/mh_kill_worker.py``; started by ``parallel.launch.spawn``:

    spawn("tf2_tpu_torch.bench.mh_worker:kill", 2, device="cpu", args=[out_dir, "cpu"])

Every rank builds the same seeded artifact (``bench/multihost_sim.py``'s
``sim_artifact``: the artifact is the contract between ranks) and one
``MultiHostEngine`` over ``make_mesh(tp=1)``. The lockstep program that
succeeds is ``bench/mesh_worker.py``'s ``multihost``.

``kill``: rank 1 follows one step and exits hard (a host crash between
steps). The coordinator serves through a ContinuousBatcher with a 30 s
step watchdog: batch 1 must succeed, every request of batch 2 must fail
(``StepTimeout`` or the backend's error) instead of wedging the batcher.
It writes ``verdict.json`` and exits without the shutdown broadcast.
"""
from __future__ import annotations

import json
import os

import numpy as np


def kill(out_dir: str, device: str = "cuda", step_timeout_s: float = 30.0) -> None:
    from tf2_tpu_torch.bench.multihost_sim import sim_artifact
    from tf2_tpu_torch.parallel import make_mesh
    from tf2_tpu_torch.runtime.distributed import Heartbeat
    from tf2_tpu_torch.serve.multihost import MultiHostEngine

    art = sim_artifact()
    mh = MultiHostEngine(art.graph, art.params, mesh=make_mesh(tp=1),
                         step_timeout_s=step_timeout_s, device=device)
    if not mh.is_coordinator:
        mh.worker_loop(max_steps=1)
        print(f"victim {mh.process_index} exiting mid-stream", flush=True)
        os._exit(0)
    hb = Heartbeat(stale_after_s=45.0)
    batcher = mh.make_batcher(max_wait_s=0.001)
    shape = mh.input_shape[1:]
    futs1 = [batcher.submit(np.zeros(shape, np.float32)) for _ in range(mh.global_batch)]
    ok1 = all(f.result(120) is not None for f in futs1)
    hb.beat()
    # the victim exits after its single step: batch 2 must error, not hang
    futs2 = [batcher.submit(np.zeros(shape, np.float32)) for _ in range(mh.global_batch)]
    errs = []
    for f in futs2:
        try:
            f.result(3 * step_timeout_s)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 (the verdict records the type)
            errs.append(type(e).__name__)
    batcher.stop(drain=False)
    verdict = {"batch1_ok": bool(ok1), "batch2_errors": errs,
               "all_errored": all(e is not None for e in errs),
               "timeout_seen": any(e == "StepTimeout" for e in errs),
               "healthy_after": hb.healthy()}
    with open(os.path.join(out_dir, "verdict.json"), "w") as f:
        json.dump(verdict, f)
    print(f"coordinator verdict: {verdict}", flush=True)
    # the victim is dead: exit without the shutdown broadcast, which would
    # block on the missing peer
    os._exit(0)
