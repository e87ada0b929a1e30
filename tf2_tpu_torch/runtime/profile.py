"""Where an Engine forward spends its time on the card, from a
torch.profiler trace.

    python -m tf2_tpu_torch.runtime.profile [--model NAME] [--trace-dir DIR]

Builds the model's synthetic W4-PoT artifact (224x224, 1000 classes;
``--model`` is resnet50, the default, googlenet or squeezenet_v1_1), warms
an Engine up at batch 64 and at batch 1, then profiles 5 back-to-back
forwards of each; then the same with the model's Engine option on
(``block_fusion=True`` for ResNet-50, ``merge_1x1=True`` for the others).
Prints one JSON line per engine and batch: device time per forward by kernel family (the
port's kernels by name, PyTorch's own kernels by short name) and by
graph op (the executor's "<op>:<node>" ranges, where the trace has them on
the device timeline), the host wall time per forward, and the device's
idle share of that wall time (1 - union of kernel intervals / wall).
With ``--trace-dir`` the Chrome traces are kept there as
``profile_<model>_b<B>.json`` and ``profile_<model>_<option>_b<B>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
import time

import numpy as np
import torch

from .. import kernels

BATCHES = (64, 1)
STEPS = 5
OPTIONS = {"resnet50": "block_fusion", "googlenet": "merge_1x1",
           "squeezenet_v1_1": "merge_1x1"}  # model -> the Engine option it profiles


def kernel_family(name: str) -> str:
    """The port's kernels by their wrapper's name (a key of
    ``kernels.launch_counts()``, which each CUDA kernel carries as the tag
    type of its first template argument); others by the kernel's own short
    name (template and parameter lists dropped)."""
    for wrapper in kernels.launch_counts():
        if re.search(rf"\b{wrapper}\b", name):
            return wrapper
    short = re.split(r"[<(]", name.replace("(anonymous namespace)::", "").removeprefix("void "))[0]
    return "torch:" + short.split("::")[-1]


def summarize(trace_path: str, steps: int, wall_s: float) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_family: dict[str, list] = {}
    for e in kernels:
        fam = kernel_family(e["name"]) if e["cat"] == "kernel" else e["cat"]
        acc = by_family.setdefault(fam, [0.0, 0])
        acc[0] += e["dur"] / 1e3 / steps
        acc[1] += 1 / steps
    by_op: dict[str, float] = {}  # "<op>:<node>" ranges on the device timeline
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and ":" in e.get("name", ""):
            op = e["name"].split(":")[0]
            by_op[op] = by_op.get(op, 0.0) + e["dur"] / 1e3 / steps
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, -1.0
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    wall_ms = wall_s * 1e3 / steps
    busy_ms = busy / 1e3 / steps
    return {"wall_ms_per_forward": wall_ms, "device_busy_ms_per_forward": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "by_family": {k: {"ms_per_forward": v[0], "launches_per_forward": v[1]}
                          for k, v in sorted(by_family.items(), key=lambda kv: -kv[1][0])},
            "device_ms_by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1]))}


def profile(engine, image: torch.Tensor, trace_path: str) -> dict:
    from torch.profiler import ProfilerActivity

    for _ in range(2):
        engine(image=image)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(STEPS):
            engine(image=image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    prof.export_chrome_trace(trace_path)
    return summarize(trace_path, STEPS, wall)


def main() -> None:
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(OPTIONS), default="resnet50")
    ap.add_argument("--trace-dir", help="keep the Chrome traces here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    option = OPTIONS[args.model]
    art = synthetic_quantized(args.model, seed=0, batch=1, image=224, classes=1000)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        images = {b: torch.as_tensor(rng.standard_normal((b, 224, 224, 3),
                                                         dtype=np.float32)).cuda()
                  for b in BATCHES}
        for flag in (False, True):
            for b in BATCHES:
                eng = Engine(art.graph.with_batch_size(b), art.params, **{option: flag})
                name = f"profile_{args.model}_{option + '_' if flag else ''}b{b}.json"
                out = profile(eng, images[b], os.path.join(trace_dir, name))
                print(json.dumps({"model": args.model, "batch": b, option: flag,
                                  "device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
