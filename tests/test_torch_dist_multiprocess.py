"""Multi-process lockstep serving of the port, against the reference's
tests/dist/test_multiprocess.py: real OS processes in a gloo world over
loopback (``bench/multihost_sim.py`` and ``bench/mh_worker.py`` through
``parallel.launch.spawn``, every wait bounded, the port from a bound port
0). Two processes run the lockstep ``MultiHostEngine`` on both data
planes, bit for bit equal to one ``Engine(device="cpu")``; a process
killed mid-stream makes the coordinator's batcher fail every in-flight
request instead of wedging;
``entry.dryrun_multichip`` on 2 and 4 CPU ranks."""
import json

import numpy as np
import pytest
import torch

from tf2_tpu_torch.bench import multihost_sim
from tf2_tpu_torch.entry import dryrun_multichip
from tf2_tpu_torch.parallel.launch import spawn
from tf2_tpu_torch.runtime import Engine

SPAWN_S = 240
CPU_ENV = {"OMP_NUM_THREADS": "1"}


def test_two_process_lockstep_parity(tmp_path):
    report = multihost_sim.run_sim(2, "cpu", tmp_path, steps=2, timeout_s=SPAWN_S)
    res = np.load(tmp_path / "multihost.npz")
    stats = report["multihost"]
    assert (report["backend"], stats["global_batch"], stats["local_batch"]) == ("gloo", 8, 4)
    assert stats["img_s"] > 0 and stats["img_s_local"] > 0
    # one process's Engine on the same seeded artifact and inputs
    art = multihost_sim.sim_artifact()
    x = multihost_sim.sim_inputs(art.graph.inputs["image"].shape)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = Engine(art.graph, art.params, device="cpu")
        want = eng.run(image=x).numpy()
        want_reversed = eng.run(image=np.ascontiguousarray(x[::-1])).numpy()
    finally:
        torch.set_num_threads(prev)
    np.testing.assert_array_equal(res["global_plane"], want, err_msg="coordinator-fed")
    np.testing.assert_array_equal(res["global_plane_reversed"], want_reversed,
                                  err_msg="coordinator-fed, second batch")
    np.testing.assert_array_equal(res["local_plane"], want, err_msg="shard-local, gathered")
    # gather=False: the coordinator keeps only its own rows (the first half)
    np.testing.assert_array_equal(res["own_rows"], want[:stats["local_batch"]])


def test_host_kill_midstream_drains_batcher(tmp_path):
    """One process dies between lockstep steps; the coordinator's
    continuous batcher hands every in-flight request an error (the
    watchdog's StepTimeout or the backend's broken connection)."""
    spawn("tf2_tpu_torch.bench.mh_worker:kill", 2, device="cpu",
          args=[str(tmp_path), "cpu", 10.0], timeout_s=SPAWN_S, env=CPU_ENV)
    verdict = json.loads((tmp_path / "verdict.json").read_text())
    assert verdict["batch1_ok"], "healthy step failed before the injection"
    assert verdict["all_errored"], f"batcher wedged or answered: {verdict['batch2_errors']}"
    assert verdict["healthy_after"]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu(n, capsys):
    dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"dryrun_multichip ok: mesh dp={n // 2} tp=2 out=({n}, 64) "
                    "backend=gloo device=cpu")


def test_local_shard_bounds_and_scaling_efficiency():
    from tf2_tpu_torch.serve.multihost import local_shard_bounds, scaling_efficiency

    assert [local_shard_bounds(8, p, 4) for p in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError):
        local_shard_bounds(6, 0, 4)
    assert scaling_efficiency(100.0, 150.0, 2) == 0.75
