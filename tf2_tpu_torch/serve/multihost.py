"""Multi-process lockstep serving, the counterpart of the reference's
``tf2_tpu/serve/multihost.py`` on ``torch.distributed``.

Execution model (one process a device, every process the same program):

- ``runtime.distributed.initialize`` joins the process group; rank 0 is the
  coordinator.
- ``MultiHostEngine`` runs one meshed Engine (``Engine(mesh=...)``) a rank:
  each dp index runs its rows of the global batch, each tp index its
  slice of the output channels.
- The step protocol is lockstep with two data planes, as the reference's:
  * coordinator-fed (``step(batch_np)``): the coordinator broadcasts a step
    descriptor ``[seq, mode, gather]`` and then the global batch; every
    rank cuts out its rows. O(global) broadcast traffic, kept for the
    single-frontend continuous batcher.
  * shard-local (``step(local_rows=...)``): only the descriptor is
    broadcast; every rank feeds its own rows, and with ``gather=False``
    keeps only its own output rows.
  The descriptor is an int64 tensor broadcast from rank 0 over the world
  group, on the backend's device (the card for NCCL, the host for gloo).
  Outputs come from ``Engine.gather`` (``gather=True``) or stay local.
- The coordinator wraps the loop in a ``ContinuousBatcher``.
- Failure: a dead peer breaks the broadcast or a collective; the step
  errors, or, with ``step_timeout_s``, raises ``StepTimeout`` instead of
  hanging; the batcher hands the error to every in-flight request.
  Recovery is restart + artifact reload + rejoin (stateless engine).
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

_STOP = -1
_MODE_GLOBAL = 1   # coordinator broadcasts the full batch
_MODE_LOCAL = 2    # descriptor only; every rank feeds its own rows


class StepTimeout(RuntimeError):
    """A lockstep step did not complete within step_timeout_s: the liveness
    signal for a dead peer (a collective blocks on a missing participant,
    so failing fast needs a watchdog)."""


def local_shard_bounds(global_batch: int, process_index: int,
                       process_count: int) -> tuple[int, int]:
    """Contiguous equal split of the global batch across processes."""
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} must divide across "
                         f"{process_count} hosts")
    per = global_batch // process_count
    return process_index * per, (process_index + 1) * per


def scaling_efficiency(img_s_1: float, img_s_n: float, n: int) -> float:
    """Measured N-process throughput against N times one process's."""
    return img_s_n / (n * img_s_1)


def _to_host(out) -> np.ndarray:
    return (out[0] if isinstance(out, tuple) else out).cpu().numpy()


class MultiHostEngine:
    """Lockstep global-batch executor over all ranks. Every process builds
    it with the same graph and params (the artifact is the contract) and
    then drives steps (the coordinator) or follows them (``worker_loop``).
    ``engine_kw`` go to the Engine (``device``, the load options)."""

    def __init__(self, graph, params, mesh=None, step_timeout_s: float | None = None,
                 **engine_kw):
        from ..parallel.mesh import make_mesh
        from ..runtime.engine import Engine

        if mesh is None:
            mesh = make_mesh()
        self.mesh_cfg = mesh
        self.engine = Engine(graph, params, mesh=mesh, **engine_kw)
        self.graph = self.engine.graph
        self.input_name = next(iter(graph.inputs))
        spec = graph.inputs[self.input_name]
        self.global_batch = spec.shape[0]
        self.input_shape = tuple(spec.shape)
        self.input_dtype = np.dtype(spec.dtype)
        joined = dist.is_initialized()
        self.process_index = dist.get_rank() if joined else 0
        self.process_count = dist.get_world_size() if joined else 1
        self.is_coordinator = self.process_index == 0
        self.step_timeout_s = step_timeout_s
        self._seq = 0
        rows = self.engine.rows
        self._rows = rows if rows is not None else (0, self.global_batch)

    @property
    def local_batch(self) -> int:
        """The rows each rank runs: global / dp (the whole batch where the
        Engine replicates it)."""
        return self._rows[1] - self._rows[0]

    # ---- lockstep protocol ----
    def _bcast(self, value: np.ndarray) -> np.ndarray:
        """Rank 0's ``value`` on every rank (a no-op without a group)."""
        if not dist.is_initialized():
            return value
        from ..parallel.mesh import to_collective
        t = to_collective(torch.from_numpy(np.ascontiguousarray(value)))
        dist.broadcast(t, src=0)
        return t.cpu().numpy()

    def _run_sharded(self, local: np.ndarray, gather: bool) -> np.ndarray:
        out = self.engine(**{self.input_name: torch.from_numpy(local)})
        return _to_host(self.engine.gather(out) if gather else out)

    def _global_rows(self) -> np.ndarray:
        """This rank's rows of the coordinator's broadcast batch."""
        payload = self._bcast(np.zeros(self.input_shape, self.input_dtype))
        return payload[self._rows[0]:self._rows[1]]

    def _step_inner(self, batch_np, local_rows, gather: bool):
        mode = _MODE_LOCAL if local_rows is not None else _MODE_GLOBAL
        if self.is_coordinator and mode == _MODE_GLOBAL and batch_np is None:
            raise ValueError("coordinator must supply batch_np or local_rows")
        desc = self._bcast(np.array([self._seq, mode, int(gather)], np.int64))
        if desc[1] == _STOP:
            return None
        # the coordinator's descriptor is authoritative: mode and gather
        # agree on every rank
        mode, gather = int(desc[1]), bool(desc[2])
        self._seq += 1
        if mode == _MODE_LOCAL:
            local = np.ascontiguousarray(local_rows, self.input_dtype)
            if local.shape[0] != self.local_batch:
                raise ValueError(f"local_rows batch {local.shape[0]} != global/dp = "
                                 f"{self.local_batch}")
        elif self.is_coordinator:
            payload = self._bcast(np.ascontiguousarray(batch_np, self.input_dtype))
            local = payload[self._rows[0]:self._rows[1]]
        else:
            local = self._global_rows()
        return self._run_sharded(np.ascontiguousarray(local), gather)

    def step(self, batch_np: np.ndarray | None = None, *,
             local_rows: np.ndarray | None = None, gather: bool = True) -> np.ndarray | None:
        """One lockstep step.

        Coordinator-fed: pass ``batch_np`` (the global batch, broadcast;
        every rank returns the gathered output). Shard-local: pass
        ``local_rows`` (this rank's rows only; no batch broadcast; with
        ``gather=False`` each rank returns only its own output rows).

        With ``step_timeout_s`` set, a step blocked on a dead peer raises
        StepTimeout instead of hanging the serving loop (the step's thread
        is abandoned: recovery is process restart + artifact reload)."""
        if self.step_timeout_s is None:
            return self._step_inner(batch_np, local_rows, gather)
        result: list = []
        err: list = []

        def run():
            try:
                result.append(self._step_inner(batch_np, local_rows, gather))
            except BaseException as e:  # noqa: BLE001 (relayed below)
                err.append(e)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(self.step_timeout_s)
        if th.is_alive():
            raise StepTimeout(f"lockstep step {self._seq} stuck > {self.step_timeout_s}s: "
                              "peer presumed dead; restart + rejoin required")
        if err:
            raise err[0]
        return result[0]

    def shutdown(self) -> None:
        """Coordinator: release the workers from worker_loop()."""
        if self.is_coordinator:
            self._bcast(np.array([self._seq, _STOP, 0], np.int64))

    def worker_loop(self, max_steps: int | None = None,
                    feed: Callable[[int, int], np.ndarray] | None = None) -> int:
        """Non-coordinator ranks: follow the coordinator's steps until
        shutdown. ``feed(seq, n_rows)`` supplies this rank's rows for
        shard-local steps; zeros where it is absent. Returns the steps
        followed."""
        steps = 0
        while max_steps is None or steps < max_steps:
            desc = self._bcast(np.zeros(3, np.int64))
            if desc[1] == _STOP:
                return steps
            gather = bool(desc[2])
            self._seq += 1
            if desc[1] == _MODE_LOCAL:
                n = self.local_batch
                local = (feed(int(desc[0]), n) if feed is not None
                         else np.zeros((n,) + self.input_shape[1:], self.input_dtype))
            else:
                local = self._global_rows()
            self._run_sharded(np.ascontiguousarray(local, self.input_dtype), gather)
            steps += 1
        return steps

    # ---- serving front end ----
    def make_batcher(self, max_wait_s: float = 0.002):
        """Coordinator-side continuous batcher feeding lockstep steps."""
        from .batcher import ContinuousBatcher

        if not self.is_coordinator:
            raise RuntimeError("batcher runs on the coordinator only")
        return ContinuousBatcher(run_batch=lambda b: self.step(b),
                                 batch_size=self.global_batch,
                                 example_shape=self.input_shape[1:],
                                 max_wait_s=max_wait_s, dtype=self.input_dtype).start()

    # ---- measurement ----
    def measure_throughput(self, n_steps: int = 8, shard_local: bool = False) -> float:
        """Lockstep steps/s -> img/s, on the host's clock (the coordinator
        drives; the other ranks call worker_loop(n_steps + 1)).
        ``shard_local=True`` measures the descriptor-only data plane (no
        batch broadcast, no output gather)."""
        if shard_local:
            x = np.zeros((self.local_batch,) + self.input_shape[1:], self.input_dtype)
            args, kw = (), {"local_rows": x, "gather": False}
        else:
            args, kw = (np.zeros(self.input_shape, self.input_dtype),), {}
        self.step(*args, **kw)  # warm
        t0 = time.perf_counter()
        for _ in range(n_steps):
            self.step(*args, **kw)
        dt = time.perf_counter() - t0
        return self.global_batch * n_steps / dt
