"""Ring-overlapped tp matmul against all-gather-then-matmul, the
counterpart of the reference's ``bench/tp_overlap_bench.py`` at its shape
((512, 2048) x (2048, 1024), K sharded over tp): ``allgather_matmul`` and
``gspmd_matmul`` (``parallel/tp_overlap.py``) on ``--world`` local ranks,
f32 and int8, each checked against the dense product (int8 bit for bit,
f32 within the reference test's rtol 1e-5 / atol 1e-4) and timed on each
rank's clock around calls that end in a synchronize (CUDA events on the
card). On the CPU (gloo over loopback) and on one shared card (gloo,
through the host) it measures the schedule's structure, not a link's
overlap.

    python -m tf2_tpu_torch.bench.tp_overlap_bench [--world 2] [--device cuda|cpu] [--out F]

Prints one JSON line and writes it to ``--out`` (default
``tf2_tpu_torch/bench/out/tp_overlap.json``, git-ignored; the reference's
``TP_OVERLAP.json`` at the repository root is not this bench's).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.launch import spawn

OUT_DIR = Path(__file__).with_name("out")   # the default --out's directory, git-ignored

SHAPE = (512, 2048, 1024)   # the reference bench's m, k, n


def _time_ms(fn, device: torch.device, iters: int, reps: int) -> float:
    """Median over ``reps`` of the mean ms a call over ``iters`` calls."""
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iters)
        else:
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            out.append((time.perf_counter() - t) * 1e3 / iters)
    return float(np.median(out))


def rank_main(out_dir: str, device: str, iters: int, reps: int) -> None:
    from ..parallel import make_mesh
    from ..parallel.tp_overlap import allgather_matmul, gspmd_matmul

    mesh = make_mesh(tp=dist.get_world_size())
    dev = torch.device(device)
    m, k, n = SHAPE
    kc = k // mesh.tp
    rng = np.random.default_rng(0)
    cases = {"f32": (torch.as_tensor(rng.standard_normal((m, k), dtype=np.float32)),
                     torch.as_tensor(rng.standard_normal((k, n), dtype=np.float32)),
                     torch.float32),
             "int8": (torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8)),
                      torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8)),
                      torch.int32)}
    result = {}
    for label, (y, w, acc) in cases.items():
        y, w = y.to(dev), w.to(dev)
        y_local = y[:, mesh.tp_index * kc:(mesh.tp_index + 1) * kc].contiguous()
        dense = (torch._int_mm(y, w) if acc == torch.int32 else torch.matmul(y, w)).cpu()
        for name, fn in (("ring", allgather_matmul), ("gspmd", gspmd_matmul)):
            got = fn(mesh, y_local, w, acc).cpu()
            if acc == torch.int32:
                ok = torch.equal(got, dense)
            else:
                ok = torch.allclose(got, dense, rtol=1e-5, atol=1e-4)
            if not ok:
                raise RuntimeError(f"{label} {name}: differs from the dense product")
            result[f"{label}_{name}_ms"] = _time_ms(lambda: fn(mesh, y_local, w, acc), dev,
                                                    iters, reps)
        result[f"{label}_ratio_ring_over_gspmd"] = (result[f"{label}_ring_ms"]
                                                    / result[f"{label}_gspmd_ms"])
    with open(Path(out_dir) / f"rank{mesh.rank}.json", "w") as f:
        json.dump(result, f)


def measure(world: int = 2, device: str = "cuda", iters: int = 8, reps: int = 3) -> dict:
    with tempfile.TemporaryDirectory() as d:
        spawn("tf2_tpu_torch.bench.tp_overlap_bench:rank_main", world, backend="gloo",
              device=device, args=[d, device, iters, reps], timeout_s=600,
              env={"OMP_NUM_THREADS": "1"} if device == "cpu" else None)
        ranks = [json.loads((Path(d) / f"rank{r}.json").read_text()) for r in range(world)]
    m, k, n = SHAPE
    where = (f"cpu x{world} (gloo over loopback)" if device == "cpu"
             else f"{world} processes sharing {torch.cuda.get_device_name(0)} (gloo, through "
                  "the host)")
    return {"mesh": f"{where}, tp only", "shape": f"({m},{k})x({k},{n}), K sharded tp={world}",
            "int8_b_layout": "column-major (torch._int_mm's fast layout)",
            "rank0": ranks[0], "per_rank": ranks,
            "note": "schedule structure only, not a link's overlap: the ranks share one "
                    "host" + ("" if device == "cpu" else " and one card")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", default=str(OUT_DIR / "tp_overlap.json"),
                    help="also write the JSON line here (default: the git-ignored bench/out/)")
    args = ap.parse_args(argv)
    line = json.dumps(measure(args.world, args.device, args.iters))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
