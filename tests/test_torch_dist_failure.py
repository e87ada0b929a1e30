"""Failure detection and recovery of the port's distributed runtime,
against the reference's tests/dist/test_failure.py on the CPU: heartbeat
staleness, ``initialize`` with one process (no group formed, as the
reference's no-op; a named backend forms a group of one, whose barrier
passes), the backend rule, the batcher surviving a failing batch, and
stateless recovery by artifact reload. The batcher's other cases and the
HTTP server are tests/test_torch_serve.py's."""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.graph.init_params import init_params
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.parallel import make_mesh
from tf2_tpu_torch.parallel.launch import free_port
from tf2_tpu_torch.runtime.distributed import Heartbeat, barrier, initialize
from tf2_tpu_torch.serve.batcher import ContinuousBatcher
from tf2_tpu_torch.transform import QuantSpec, load_artifact, save_quantized, transform_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_heartbeat_goes_stale():
    hb = Heartbeat(stale_after_s=0.05)
    assert hb.healthy()
    time.sleep(0.08)
    assert not hb.healthy()
    hb.beat()
    assert hb.healthy()


def test_initialize_single_process(monkeypatch):
    monkeypatch.delenv("TF2TPU_NUM_PROCESSES", raising=False)
    info = initialize(device="cpu")
    assert not dist.is_initialized()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1, "backend": None}
    barrier()   # no group: nothing to wait for
    assert (make_mesh().dp, make_mesh().tp) == (1, 1)


def test_initialize_named_backend_forms_a_group_of_one():
    info = initialize(coordinator=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                      backend="gloo", device="cpu", timeout_s=30)
    try:
        assert dist.is_initialized() and info["backend"] == "gloo"
        assert (info["process_index"], info["process_count"]) == (0, 1)
        barrier("one", timeout_s=10)
        cfg = make_mesh()
        assert (cfg.dp, cfg.tp, cfg.rank) == (1, 1, 0)
    finally:
        dist.destroy_process_group()


def test_initialize_refuses_nccl_on_the_cpu():
    with pytest.raises(ValueError, match="NCCL"):
        initialize(num_processes=2, process_id=0, backend="nccl", device="cpu")
    assert not dist.is_initialized()


def test_batcher_survives_one_failing_batch():
    """Fault injection: the runner dies once mid-stream; the requests of
    that batch get the exception, the next batch succeeds (the batcher
    itself must not wedge)."""
    state = {"n": 0}

    def flaky(batch):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("injected worker death")
        return batch + 1

    b = ContinuousBatcher(flaky, batch_size=2, example_shape=(1,), max_wait_s=0.001).start()
    try:
        f1 = b.submit(np.zeros((1,), np.float32))
        with pytest.raises(RuntimeError, match="injected"):
            f1.result(5)
        f2 = b.submit(np.zeros((1,), np.float32))
        np.testing.assert_array_equal(f2.result(5), np.ones((1,)))
    finally:
        b.stop(drain=False)


def test_artifact_reload_is_recovery(tmp_path):
    """Stateless recovery: drop the artifact, reload it from disk, the same
    outputs bit for bit (the artifact is the checkpoint)."""
    g = get_model("squeezenet_v1_1", batch=1, image=32, classes=10)
    params = init_params(g, seed=0)
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    art, _, _ = transform_model(g, params, [{"image": x}], qspec=QuantSpec(pot_candidates=5),
                                device="cpu")
    save_quantized(str(tmp_path / "a"), art)
    ones = torch.ones(g.inputs["image"].shape)
    y1 = execute(art.graph)({k: torch.as_tensor(v) for k, v in art.params.items()}, image=ones)
    del art   # "crash"
    g2, p2 = load_artifact(str(tmp_path / "a"))
    y2 = execute(g2)({k: torch.as_tensor(v) for k, v in p2.items()}, image=ones)
    assert torch.equal(y1, y2)
