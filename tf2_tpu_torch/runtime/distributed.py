"""Joining the process group, the counterpart of the reference's
``tf2_tpu/runtime/distributed.py`` on ``torch.distributed``.

Every process runs the same program and drives one device. ``initialize``
reads the reference's variables: ``TF2TPU_NUM_PROCESSES`` (default 1),
``TF2TPU_PROCESS_ID`` (default 0), ``TF2TPU_COORDINATOR`` (default
``127.0.0.1:8890``, rank 0's address, ``tcp://`` rendezvous) and, for the
card, ``TF2TPU_LOCAL_RANK`` (default: the process id modulo the cards the
host has). The backend is NCCL where the process's device is the card
(``torch.cuda.set_device(local_rank)``), gloo where the caller asks for
the CPU (``device="cpu"``) or names it. NCCL takes one rank a card: two
ranks on one card use gloo, whose collectives run on the host
(``parallel/mesh.py``).

Failure model (as the reference's): the engine is stateless (the artifact
is the checkpoint), so recovery is process restart + artifact reload +
rejoin. ``Heartbeat`` is the liveness signal the serving layer exports; a
missed barrier at start-up fails fast rather than hanging.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from ..parallel.mesh import to_collective


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout_s: float = 120.0,
               backend: str | None = None, device: str = "cuda") -> dict:
    """Join the process group (none is formed for one process unless a
    backend is named). Returns topology facts: the reference's four keys
    and ``backend`` (None without a group)."""
    n = num_processes or int(os.environ.get("TF2TPU_NUM_PROCESSES", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("TF2TPU_PROCESS_ID", "0"))
    if backend is None and n > 1:
        backend = "gloo" if device == "cpu" else "nccl"
    if backend is not None and not dist.is_initialized():
        if device != "cpu":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
            local = int(os.environ.get("TF2TPU_LOCAL_RANK", rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        elif backend == "nccl":
            raise ValueError("NCCL runs on the card: device='cpu' takes gloo")
        addr = coordinator or os.environ.get("TF2TPU_COORDINATOR", "127.0.0.1:8890")
        dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=n,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    return {"process_index": dist.get_rank() if joined else 0, "process_count": world,
            "local_devices": 1, "global_devices": world,
            "backend": dist.get_backend() if joined else None}


def barrier(name: str = "startup", timeout_s: float = 60.0) -> None:
    """Every process must arrive: an all-reduce of ones that must equal the
    world size, waited on for at most ``timeout_s``. Without a process
    group there is nothing to wait for."""
    if not dist.is_initialized():
        return
    x = to_collective(torch.ones(1, dtype=torch.float32))
    dist.all_reduce(x, async_op=True).wait(timeout=datetime.timedelta(seconds=timeout_s))
    if int(x.item()) != dist.get_world_size():
        raise RuntimeError(f"barrier {name!r}: {int(x.item())} of "
                           f"{dist.get_world_size()} processes arrived")


class Heartbeat:
    """Liveness for the serving layer: a monotonically bumped timestamp the
    health endpoint reads; staleness => unhealthy."""

    def __init__(self, stale_after_s: float = 10.0):
        self.stale_after_s = stale_after_s
        self._last = time.monotonic()

    def beat(self) -> None:
        self._last = time.monotonic()

    def healthy(self) -> bool:
        return (time.monotonic() - self._last) < self.stale_after_s

    def age_s(self) -> float:
        return time.monotonic() - self._last
