"""End-to-end throughput and latency of the port's Engine against another
revision of the whole package, on one card, in one call:

    python -m tf2_tpu_torch.bench.engine_ab --parent DIR [--rounds R]

``DIR`` holds another revision's tree (for the parent commit: ``git
archive PARENT | tar -x -C DIR``). Each revision runs in a process of its
own (its package first on ``sys.path``, its kernels built in its own
tree), in the order parent, this, this, parent (``R`` times over):
``Engine.benchmark`` (CUDA events around back-to-back forwards, the median
of 3 runs) of ResNet-50 (default and ``block_fusion=True``), ViT-B/16 W8
(``vit_b16``), GoogLeNet and SqueezeNet v1.1 at batch 64 and 1 on the same
seeded synthetic artifacts and images. The host-bound runs (batch 1,
GoogLeNet and SqueezeNet at 64) spread widely between processes, so take
more than one round. Prints one JSON line with the card's name and power
limit and each run's numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import tf2_tpu_torch
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine
out = {"tree": sys.argv[1], "package": tf2_tpu_torch.__file__}
rng = np.random.default_rng(0)
for name, kw, options in [("resnet50", {}, {"default": {}, "block_fusion": {"block_fusion": True}}),
                          ("vit_b16", {"weight_bits": 8}, {"default": {}}),
                          ("googlenet", {}, {"default": {}}),
                          ("squeezenet_v1_1", {}, {"default": {}})]:
    art = synthetic_quantized(name, seed=0, batch=64, **kw)
    for b in (64, 1):
        x = rng.standard_normal((b, 224, 224, 3), dtype=np.float32)
        for label, flags in options.items():
            eng = Engine(art.graph.with_batch_size(b), art.params, **flags)
            r = eng.benchmark(iters=20 if b == 64 else 100, reps=3, image=x)
            out[f"{name} {label} b{b}"] = {"img_per_s": r["throughput_per_s"],
                                           "latency_ms": r["latency_s"] * 1e3,
                                           "per_rep_ms": [t * 1e3 for t in r["per_rep_s"]]}
            del eng
            torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times over the order parent, this, this, parent")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    this = Path(__file__).resolve().parents[2]
    runs = []
    order = [("parent", args.parent), ("this", this), ("this", this), ("parent", args.parent)]
    for label, tree in order * args.rounds:
        done = subprocess.run([sys.executable, "-c", _RUN, str(Path(tree).resolve())],
                              capture_output=True, text=True, cwd=str(tree))
        if done.returncode:
            sys.stderr.write(done.stderr[-4000:])
            raise SystemExit(f"engine_ab: the {label} run failed")
        row = {"revision": label, **json.loads(done.stdout.strip().splitlines()[-1])}
        runs.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
