"""Local ranks on one host: ``spawn`` starts ``world`` processes, each
``python -m tf2_tpu_torch.parallel.launch``, which joins the process group
(``runtime.distributed.initialize`` on ``127.0.0.1`` and a free port) and
calls a function named by its import path, ``"package.module:function"``,
with JSON arguments. Every wait is bounded: a rank that exits non-zero, or
a run that outlasts ``timeout_s``, kills the other ranks and raises with
each rank's log.

    spawn("tf2_tpu_torch.bench.mesh_worker:run", 2, backend="gloo",
          device="cuda", args=[config_path])
"""
from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]   # the directory that holds tf2_tpu_torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, *, backend: str | None = None, device: str = "cuda",
          args=(), timeout_s: float = 300.0, env: dict | None = None) -> list[str]:
    """Run ``target(*args)`` on ``world`` local ranks; returns each rank's
    log (stdout and stderr). ``backend`` None: NCCL on the card, gloo on
    the CPU (``initialize``'s rule). ``env`` is added to this process's
    environment."""
    port = free_port()
    child_env = {**os.environ, **(env or {})}
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), child_env.get("PYTHONPATH")) if p)
    child_env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
    with tempfile.TemporaryDirectory() as d:
        paths = [Path(d) / f"rank{r}.log" for r in range(world)]
        procs = []
        try:
            for r, path in enumerate(paths):
                with open(path, "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "tf2_tpu_torch.parallel.launch", target, str(r),
                         str(world), str(port), backend or "", device, json.dumps(list(args))],
                        stdout=log, stderr=subprocess.STDOUT, env=child_env))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    break
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    why = (f"rank {failed[0]} exited {codes[failed[0]]}" if failed
                           else f"timed out after {timeout_s:.0f} s")
                    tails = "\n".join(f"--- rank {r} ---\n{p.read_text()[-3000:]}"
                                      for r, p in enumerate(paths))
                    raise RuntimeError(f"spawn {target} x{world}: {why}\n{tails}")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return [p.read_text() for p in paths]


def main(argv) -> None:
    target, rank, world, port, backend, device, args = argv
    from ..runtime.distributed import initialize

    info = initialize(coordinator=f"127.0.0.1:{port}", num_processes=int(world),
                      process_id=int(rank), backend=backend or None, device=device)
    print(f"rank {rank} of {world}: backend {info['backend']}, device {device}", flush=True)
    module, name = target.split(":")
    getattr(importlib.import_module(module), name)(*json.loads(args))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
