"""Runs one cell of ``BENCHMARK.json`` once on the GPU and prints its result
as the last line of standard output (one JSON object).

    python -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones, read from a profiled slice of the window.
Exits 2 without a result where no GPU (or too few) is visible, and 3 where
JAX, flax or the JAX package was loaded; never runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tf2_tpu")


def _since_start() -> float:
    """Seconds from this process's start to now: its start time in clock
    ticks since boot (``/proc/self/stat``) against ``/proc/uptime``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


_AT_T0 = _since_start()


def elapsed() -> float:
    return _AT_T0 + time.perf_counter() - _T0


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``tf2_tpu_torch`` is not ``tf2_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _env() -> None:
    """Every cache inside the checkout, at fixed paths; the port's defaults
    (no tuned routing table, no kernel cache elsewhere)."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for var in ("TF2TPU_TORCH_TUNE_DIR", "TF2TPU_TORCH_KERNEL_CACHE"):
        os.environ.pop(var, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch

    print(f"perfbench: set-up imports {elapsed():.3f} s since the process started",
          file=sys.stderr)

    from . import harness, manifest

    cell = manifest.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} GPU(s), {n} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, elapsed)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
