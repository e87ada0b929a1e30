"""Measured peaks of the card, the probes of the reference's
``bench/peaks.py`` on the H100: an int8 GEMM (8192^3, ``torch._int_mm``,
with B stored row-major and column-major, since the layout can change the
library's path; ``int8_tops`` is the faster),
a bf16 GEMM (8192^3, ``torch.matmul``), and HBM streaming over a 1 GiB f32
vector: 1 read 1 write (``x * 1.5``), 2 reads 1 write (``x + y``) and a
read-only sum. These probe the card; they port no kernel. Each is timed
with CUDA events over back-to-back calls, the median of 3 runs.

    python -m tf2_tpu_torch.bench.peaks [--out FILE]

Prints one JSON report (with the card's name and power limit); writes a
file only where ``--out`` names one. Raises without a card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..kernels.autotune import card_name

GEMM_N = 8192               # the square GEMMs' side
VECTOR_BYTES = 1 << 30      # the HBM probes' f32 vector


def _median_s(fn, iters: int, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / 1e3 / iters)
    return float(np.median(runs))


def measure() -> dict:
    """The probes on the current card. -> {int8_tops (and each layout's:
    int8_tops_row_major_b, int8_tops_col_major_b), bf16_tflops,
    hbm_1r1w_gbps, hbm_2r1w_gbps, hbm_read_sum_gbps, card, device}."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench.peaks measures a CUDA device; none is available")
    dev, n = torch.device("cuda"), GEMM_N
    out = {"card": card_name(), "device": torch.cuda.get_device_name(dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    a8 = torch.randint(-100, 100, (n, n), generator=gen, device=dev, dtype=torch.int8)
    b8 = torch.randint(-100, 100, (n, n), generator=gen, device=dev, dtype=torch.int8)
    b8_cols = b8.t().contiguous().t()  # the same matrix stored column-major
    for label, b in (("row_major_b", b8), ("col_major_b", b8_cols)):
        t = _median_s(lambda: torch._int_mm(a8, b), iters=16)
        out[f"int8_tops_{label}"] = 2 * n ** 3 / t / 1e12
    del b8_cols
    out["int8_tops"] = max(out["int8_tops_row_major_b"], out["int8_tops_col_major_b"])
    abf, bbf = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    del a8, b8
    t = _median_s(lambda: torch.matmul(abf, bbf), iters=16)
    out["bf16_tflops"] = 2 * n ** 3 / t / 1e12
    del abf, bbf
    x = torch.ones(VECTOR_BYTES // 4, device=dev, dtype=torch.float32)
    y = torch.ones_like(x)
    t = _median_s(lambda: x * 1.5, iters=12)
    out["hbm_1r1w_gbps"] = 2 * VECTOR_BYTES / t / 1e9
    t = _median_s(lambda: x + y, iters=12)
    out["hbm_2r1w_gbps"] = 3 * VECTOR_BYTES / t / 1e9
    t = _median_s(lambda: x.sum(), iters=12)
    out["hbm_read_sum_gbps"] = VECTOR_BYTES / t / 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    report = measure()
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
