"""The readings the limits of ``correct`` are set from, in one process on
the GPU: for each of ``--seeds``, the program's numbers (a short window of
the cell's own traffic, the same sample as a run compares); for each of
``--control-seeds``, the control's (the reference at 4-bit activations in
the program's place, on the rows a run would sample). Prints one JSON line
a seed and a summary line.

    python -m perfbench.readings --workload <name> --seeds 1 2 ... \\
        --control-seeds 7 8 9 [--seconds 2]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import harness, manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = manifest.load(args.workload)
    program, ctrl = [], []
    for seed in args.seeds:
        t = time.perf_counter()
        art_dir, pool, batches, eng = harness.setup(cell, seed, device)
        call = lambda x: eng(image=x)  # noqa: E731
        g = harness.arrival_gaps(cell.traffic, seed)
        harness.drive(call, batches, harness.WARM_S, g)
        w, _ = harness.drive(call, batches, args.seconds, g)
        del eng, call
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        nums = harness.judge(cell, seed, art_dir, pool, w, device)
        program.append(nums)
        print(json.dumps({"seed": seed, "side": "program", "calls": len(w.calls), **nums,
                          "reference_s": time.perf_counter() - t_ref,
                          "seed_s": time.perf_counter() - t}), flush=True)
    for seed in args.control_seeds:
        art_dir, pool, _, eng = harness.setup(cell, seed, device)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        nums = harness.control(cell, seed, art_dir, pool, device)
        ctrl.append(nums)
        print(json.dumps({"seed": seed, "side": "control", **nums}), flush=True)
    summary = {"workload": args.workload}
    for key in ("max_gap_codes", "mismatch_pct"):
        if program:
            summary[f"program_max_{key}"] = max(p[key] for p in program)
        if ctrl:
            summary[f"control_min_{key}"] = min(c[key] for c in ctrl)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
