"""Host time of a kernel wrapper against another, in one process on one
card:

    python -m tf2_tpu_torch.bench.wrapper_ab --parent DIR [--rounds R]
    python -m tf2_tpu_torch.bench.wrapper_ab --stem [--rounds R]

``DIR`` holds another revision's tree (for the parent commit: ``git
archive PARENT | tar -x -C DIR``). Its package is loaded beside this one
under another name, its kernels built in its own tree. Each revision builds
its Engine of the batch-1 ResNet-50 (the same seeded synthetic artifact) and
calls its ``shift_matmul.qmatmul_pot4`` on the first pot4 GEMM node (a 1x1
stride-1 conv, (3136, 64) x (64, 256)) with the weights as its Engine holds
them and the same random int8 input. With ``--stem`` (no other revision)
the two sides are this revision's ways to run that Engine's stem node on
the same random f32 image: the stem kernel, as the Engine routes it (one
``fused_qstem`` launch on the prepared weight; "this"), and the two passes
it replaces, the eager quantize and ``qconv_s2`` (the node on the HWIO
weight; "parent"). A reading is the host's clock over
500 back-to-back calls, divided by 500; the card is synchronized between
readings, and 500 launches do not fill its queue, so no call waits for the
kernels before it and what shows is the wrapper's host time (its checks,
the output's allocation and the launch). Both revisions share the process
and its host, in the order parent, this, this, parent, ``R`` times over.
Prints one JSON line with the card's name and power limit, each
revision's readings in microseconds a call, their medians and quartiles,
and how many of the 2R (parent, this) pairs this revision won.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CALLS = 500


def load_package(tree: Path, name: str):
    """The ``tf2_tpu_torch`` package of ``tree``, imported as ``name``."""
    root = tree / "tf2_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, root / "__init__.py",
                                                  submodule_search_locations=[str(root)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def pot4_call(package: str):
    """A call of ``package``'s pot4 wrapper on the first pot4 GEMM node of
    its batch-1 ResNet-50 Engine, with that Engine's weights."""
    models = importlib.import_module(f"{package}.models")
    runtime = importlib.import_module(f"{package}.runtime")
    shift_matmul = importlib.import_module(f"{package}.kernels.shift_matmul")
    art = models.synthetic_quantized("resnet50", seed=0, batch=1)
    eng = runtime.Engine(art.graph, art.params, block_fusion=False)
    node = next(n for n in eng.graph.nodes  # a 1x1 stride-1 pot4 conv: the GEMM's route
                if n.op == "qconv2d" and n.attrs.get("wfmt") == "pot4"
                and list(n.attrs["kshape"][:2]) + list(n.attrs.get("strides", [1, 1])) == [1] * 4)
    w, es, eb = (eng.params[p] for p in node.params)
    relu = node.attrs["relu"]
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(-127, 128, (3136, 2 * w.shape[0]), dtype=np.int8)).cuda()
    return lambda: shift_matmul.qmatmul_pot4(x, w, es, eb, relu)


def stem_calls():
    """(the two passes, the stem kernel) on the batch-1 ResNet-50 Engine's
    stem node: the node on the HWIO weight takes quantize + ``qconv_s2``,
    on the weight the Engine prepared, the stem kernel."""
    from tf2_tpu_torch.kernels import dispatch
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("resnet50", seed=0, batch=1)
    eng = Engine(art.graph, art.params)
    node = next(n for n in eng.graph.nodes if n.name in eng.stem_nodes)
    hwio = dict(eng.params)
    hwio[node.params[0]] = eng.params[node.params[0]].contiguous()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 224, 224, 3), dtype=np.float32)).cuda()
    return (lambda: dispatch.qconv2d(node, hwio, x), lambda: dispatch.qconv2d(node, eng.params, x),
            eng)


def reading_us(call) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        call()
    us = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--stem", action="store_true",
                    help="the stem kernel against quantize + qconv_s2, this revision")
    ap.add_argument("--rounds", type=int, default=25)
    args = ap.parse_args()
    if args.stem == (args.parent is not None):
        ap.error("give --parent DIR or --stem")
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.stem:
        two_passes, kernel, _eng = stem_calls()
        calls = {"parent": two_passes, "this": kernel}
    else:
        load_package(args.parent.resolve(), "tf2_tpu_torch_parent")
        calls = {"parent": pot4_call("tf2_tpu_torch_parent"), "this": pot4_call("tf2_tpu_torch")}
    for call in calls.values():  # warm: plans, caches, the first launches
        for _ in range(200):
            call()
    readings = {"parent": [], "this": []}
    wins = 0
    for _ in range(args.rounds):
        p0, t0 = reading_us(calls["parent"]), reading_us(calls["this"])
        t1, p1 = reading_us(calls["this"]), reading_us(calls["parent"])
        readings["parent"] += [p0, p1]
        readings["this"] += [t0, t1]
        wins += (t0 < p0) + (t1 < p1)
    out = {"card": card, "wrapper": "qstem against quantize + qconv_s2" if args.stem
           else "qmatmul_pot4", "calls_per_reading": CALLS, "pairs": 2 * args.rounds,
           "pairs_this_won": wins}
    for label, r in readings.items():
        q = statistics.quantiles(r, n=4)
        out[label] = {"median_us": statistics.median(r), "quartiles_us": [q[0], q[2]],
                      "readings_us": r}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
