"""Times every tile candidate of the pot4 GEMM's plan at the zoo's shapes on
one card, beside the plan's own choice:

    python -m tf2_tpu_torch.bench.pot4_plans

Shapes: every distinct pot4 GEMM of ResNet-50, GoogLeNet and SqueezeNet
v1.1 (default and their options, ``qgemm_ab.pot4_shapes``) at batch 64. On
each, random int8 inputs and codes (prepared K-major), the plan of
``shift_matmul.plan_pot4`` and the plans it gives for BM 128 and 64 times
its BN, half its BN (down to 16) and twice it (up to 128), each held
against ``qmatmul_pot4_plain`` (0 mismatches) and timed from a CUDA graph.
Per group (model, option) the sums a forward: the plan's, and the fastest
candidate's of each shape. Prints one JSON line with the card's name and
power limit; per-shape rows go to stderr.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from tf2_tpu_torch.bench.qconv_ab import graph_ms
from tf2_tpu_torch.bench.qgemm_ab import pot4_shapes
from tf2_tpu_torch.kernels import build, shift_matmul
from tf2_tpu_torch.transform import potq


def candidates(m: int, n: int, k: int) -> list[shift_matmul.Pot4Plan]:
    own = shift_matmul.plan_pot4(m, n, k)
    bns = {own.bn}
    if own.bn > 16:
        bns.add(own.bn // 2)
    if own.bn < 128 and own.bn < n:
        bns.add(own.bn * 2)
    plans = [own]
    for bm in (128, 64):
        for bn in sorted(bns):
            p = shift_matmul.plan_pot4(m, n, k, bm=bm, bn=bn)
            if p not in plans:
                plans.append(p)
    return plans


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pot4_plans: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    rng = np.random.default_rng(0)
    shapes = [s for s in pot4_shapes() if s[0].endswith(" b64")]
    timed, bad = {}, 0
    for m, k, n in sorted({s[1:4] for s in shapes}):
        x = torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        wp = torch.as_tensor(potq.pack_codes(rng.integers(0, 16, (k, n)).astype(np.uint8))).cuda()
        wk = shift_matmul.prepare_weight(wp)
        es = torch.as_tensor((rng.uniform(0.5, 3.0, n) / (64 * np.sqrt(k)))
                             .astype(np.float32)).cuda()
        eb = torch.as_tensor(rng.normal(0, 5, n).astype(np.float32)).cuda()
        want = shift_matmul.qmatmul_pot4_plain(x, wp, es, eb, True)
        rows = []
        for p in candidates(m, n, k):
            ws = torch.empty(max(p.ws_ints, 1), dtype=torch.int32, device=x.device)
            counters = torch.zeros(max(p.counters, 1), dtype=torch.int32, device=x.device)

            launch = shift_matmul.pot4_launch(wk, shift_matmul.prepared_ld(wk), es, eb, True,
                                              m, k, p, ws, counters)

            def run():
                return shift_matmul._call_pot4(x, launch, not p.avec)

            y = run()
            mism = int((y != want).sum())
            bad += mism
            ms = graph_ms(run, args.iters)
            rows.append({"plan": p.name, "device_ms": ms, "mismatches": mism})
        timed[(m, k, n)] = rows
        print(json.dumps({"m": m, "k": k, "n": n, "candidates": rows}), file=sys.stderr,
              flush=True)
        del x, wp, wk, es, eb, want
        torch.cuda.empty_cache()
    totals = {}
    for group, m, k, n, count in shapes:
        rows = timed[(m, k, n)]
        t = totals.setdefault(group, {"launches": 0, "plan_ms": 0.0, "best_ms": 0.0})
        t["launches"] += count
        t["plan_ms"] += count * rows[0]["device_ms"]
        t["best_ms"] += count * min(r["device_ms"] for r in rows)
    print(json.dumps({"card": card, "per_forward": totals, "mismatches": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
