"""Device time by graph node from a torch.profiler trace, reconciled with
the timed forward: the port's counterpart of ``bench/profile_trace.py``.

    python -m tf2_tpu_torch.bench.profile_trace [--model resnet50] [--batches 64,1]
        [--steps 5] [--out FILE] [--trace-dir DIR]

The model's synthetic artifact and sizes are ``runtime/profile.py``'s
(``--model``: one of its ``OPTIONS``); each batch's default Engine is
built (one CUDA graph a forward) and profiled. The join of device ops to
nodes:

- eager: each device op (kernel, memcpy, memset) carries the correlation
  id of the host call that launched it (``cudaLaunchKernel``,
  ``cudaLaunchKernelExC``, ``cudaMemcpyAsync``, ...); that call lies
  inside the executor's ``"<op>:<node>"`` range (``graph/execute.py``) on
  the host thread, which names the node. The correlation id, not the
  device timestamps, makes the join.
- captured: a replay has no ranges (the executor runs only at capture),
  and every op of one replay carries the ``cudaGraphLaunch``'s correlation
  id. ``Engine.build`` captured one eager forward, so the replay runs the
  same kernels in the same order: the i-th kernel of a replay is the i-th
  kernel of an eager forward of the same Engine (``Engine.eager``). The
  join checks that both sequences have the same length and names and
  raises otherwise. Memsets and memcpys inside the graph (a copy node that
  CUDA may run as a kernel of its own, ``memcpy128``: SSD's sorts copy
  their input so), the input's copy in and the output's copy out are rows
  of their own (``<...>``).

Each report (a batch) has ``benchmark_ms`` (``Engine.benchmark`` on the
built Engine), ``device_ms_per_forward`` (the union of the device ops'
intervals, ``runtime/profile.summarize``), ``attributed_share`` (the share
of kernel time that lands on a node), ``per_node_ms`` (sorted),
``top_device_ops``. Every model is built (SSD too: its NMS is a kernel).
Written to
``--out`` (default: the git-ignored ``bench/out/profile_trace_<model>.json``).
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUT_DIR = Path(__file__).with_name("out")   # the default --out's directory, git-ignored
STEPS = 5
# a graph's copy or set node that CUDA runs as a kernel of its own (a
# device-to-device copy in a replay: "memcpy128"); an eager forward has the
# same copy as a memcpy, outside the kernel sequence
COPY_KERNEL = re.compile(r"(memcpy|memset)\w*")


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_ops(events: list[dict]) -> list[dict]:
    """The trace's device ops in time order, each {"name", "cat", "ts",
    "dur", "launch": the launching host call's name (None if the trace has
    none), "ranges": the host ranges (``user_annotation``) around that call
    on its thread, outermost first}."""
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    by_thread: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
    starts = {}
    for k, rs in by_thread.items():
        rs.sort(key=lambda r: r["ts"])
        starts[k] = [r["ts"] for r in rs]
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        call = launch.get(e.get("args", {}).get("correlation"))
        ranges = []
        if call is not None:
            key = (call["pid"], call["tid"])
            rs = by_thread.get(key, [])
            for r in rs[:bisect.bisect_right(starts.get(key, []), call["ts"])]:
                if r["ts"] <= call["ts"] <= r["ts"] + r["dur"]:
                    ranges.append(r)
            ranges = [r["name"] for r in sorted(ranges, key=lambda r: (r["ts"], -r["dur"]))]
        ops.append({"name": e["name"], "cat": e["cat"], "ts": float(e["ts"]),
                    "dur": float(e["dur"]), "launch": call["name"] if call else None,
                    "ranges": ranges})
    ops.sort(key=lambda o: o["ts"])
    return ops


def _step(op: dict, label: str) -> str | None:
    """The ``"<label>:<i>"`` range around an op, if any."""
    return next((r for r in op["ranges"] if r.startswith(label + ":")), None)


def _node(op: dict, label: str) -> str:
    """The innermost executor range ``"<op>:<node>"`` around an op -> the
    node; ``<outside>`` where there is none."""
    names = [r for r in op["ranges"] if ":" in r and not r.startswith(label + ":")]
    return names[-1].split(":", 1)[1] if names else "<outside>"


def eager_forwards(ops: list[dict], label: str = "forward") -> list[list[dict]]:
    """The ops of each ``"<label>:<i>"`` range in order, each op given its
    ``node``."""
    steps: dict[str, list] = {}
    for op in ops:
        s = _step(op, label)
        if s is not None:
            steps.setdefault(s, []).append(dict(op, node=_node(op, label)))
    return [steps[k] for k in sorted(steps, key=lambda s: int(s.split(":")[1]))]


def kernel_sequence(forward: list[dict]) -> list[tuple[str, str]]:
    """(kernel name, node) of each kernel of one eager forward, in order."""
    return [(op["name"], op["node"]) for op in forward if op["cat"] == "kernel"]


def replay_forwards(ops: list[dict], sequence: list[tuple[str, str]],
                    label: str = "replay") -> list[list[dict]]:
    """The ops of each ``"<label>:<i>"`` range (one ``Engine`` call on a
    built Engine), each given its ``node``: the i-th kernel of the graph
    launch that of ``sequence``'s i-th (``kernel_sequence`` of an eager
    forward), after checking that both have the same length and names
    (else ``ValueError``); memsets and memcpys in the graph, CUDA's copy
    kernels (``COPY_KERNEL``) too, ``<memset (graph)>``/``<memcpy
    (graph)>``; the other ops before the graph ``<copy in>``, after it
    ``<copy out>``."""
    out = []
    for ops_i in eager_forwards(ops, label):
        graph_ops = [op for op in ops_i if op["launch"] and "GraphLaunch" in op["launch"]]
        if not graph_ops:
            raise ValueError(f"{_step(ops_i[0], label)}: no graph launch in the range")
        copies = {id(op): m.group(1) for op in graph_ops if op["cat"] == "kernel"
                  for m in [COPY_KERNEL.fullmatch(op["name"])] if m}
        kernels = [op for op in graph_ops if op["cat"] == "kernel" and id(op) not in copies]
        names = [op["name"] for op in kernels]
        want = [name for name, _ in sequence]
        if names != want:
            at = next((i for i, (a, b) in enumerate(zip(names, want)) if a != b),
                      min(len(names), len(want)))
            raise ValueError(
                f"{_step(ops_i[0], label)}: the replay's {len(names)} kernels do not match the "
                f"eager forward's {len(want)}; first difference at {at}: "
                f"{names[at] if at < len(names) else None!r} against "
                f"{want[at] if at < len(want) else None!r}")
        node_of = {id(op): sequence[i][1] for i, op in enumerate(kernels)}
        in_graph = {id(op) for op in graph_ops}
        first, last = graph_ops[0]["ts"], graph_ops[-1]["ts"]
        rows = []
        for op in ops_i:
            if id(op) in node_of:
                node = node_of[id(op)]
            elif id(op) in in_graph:
                node = f"<{copies.get(id(op)) or op['cat'].removeprefix('gpu_')} (graph)>"
            else:
                node = "<copy in>" if op["ts"] < first else "<copy out>" if op["ts"] > last \
                    else "<outside>"
            rows.append(dict(op, node=node))
        out.append(rows)
    return out


def attribution(forwards: list[list[dict]]) -> dict:
    """``per_node_ms`` (ms a forward, sorted; rows ``<...>`` are not nodes),
    ``attributed_share`` (kernel time on a node over all kernel time) and
    ``top_device_ops`` (by kernel family and node, ms a forward) of the
    attributed ``forwards``."""
    from ..runtime.profile import kernel_family

    steps = len(forwards)
    per_node: dict[str, float] = {}
    ops: dict[tuple, list] = {}
    on_node = total = 0.0
    for fwd in forwards:
        for op in fwd:
            per_node[op["node"]] = per_node.get(op["node"], 0.0) + op["dur"] / 1e3 / steps
            fam = kernel_family(op["name"]) if op["cat"] == "kernel" else op["cat"]
            acc = ops.setdefault((fam, op["node"]), [0.0, 0])
            acc[0] += op["dur"] / 1e3 / steps
            acc[1] += 1 / steps
            if op["cat"] == "kernel":
                total += op["dur"]
                on_node += op["dur"] if not op["node"].startswith("<") else 0.0
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:20]
    return {"attributed_share": on_node / total if total else 0.0,
            "per_node_ms": dict(sorted(per_node.items(), key=lambda kv: -kv[1])),
            "top_device_ops": [{"op": fam, "node": node, "ms_per_forward": v[0],
                                "launches_per_forward": v[1]} for (fam, node), v in top]}


def _trace(fn, steps: int, label: str, path: str) -> float:
    """``steps`` calls of ``fn``, each in a ``"<label>:<i>"`` range, under
    torch.profiler (host and device), the trace written to ``path``;
    returns the wall seconds."""
    import torch
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(steps):
            with torch.profiler.record_function(f"{label}:{i}"):
                fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    prof.export_chrome_trace(path)
    return wall


def profile_engine(engine, x, trace_dir: str, name: str, steps: int = STEPS) -> dict:
    """The report of one Engine on ``x``: built, a trace of one eager
    forward gives the kernel sequence and one of ``steps`` replays the
    times; not built, ``steps`` eager forwards give both."""
    import torch

    from ..runtime.profile import summarize

    for _ in range(2):
        engine(image=x)
    torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"{name}.json")
    if engine.built:
        eager_path = os.path.join(trace_dir, f"{name}_eager.json")
        _trace(lambda: engine.eager(image=x), 1, "forward", eager_path)
        sequence = kernel_sequence(eager_forwards(device_ops(load_events(eager_path)))[0])
        wall = _trace(lambda: engine(image=x), steps, "replay", path)
        forwards = replay_forwards(device_ops(load_events(path)), sequence)
    else:
        wall = _trace(lambda: engine(image=x), steps, "forward", path)
        forwards = eager_forwards(device_ops(load_events(path)))
    if len(forwards) != steps:
        raise ValueError(f"{name}: {len(forwards)} forwards in the trace, {steps} profiled")
    summary = summarize(path, steps, wall)
    batch = x.shape[0]
    bench = engine.benchmark(iters=20 if batch >= 64 else 100, reps=3, image=x)
    device_ms = summary["device_busy_ms_per_forward"]
    return {"batch": batch, "captured": engine.built, "steps": steps,
            "benchmark_ms": bench["latency_s"] * 1e3,
            "device_ms_per_forward": device_ms,
            "device_over_benchmark": device_ms / (bench["latency_s"] * 1e3),
            "wall_ms_per_forward": summary["wall_ms_per_forward"],
            **attribution(forwards), "by_family": summary["by_family"]}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..runtime.profile import OPTIONS, SIZES, WEIGHT_BITS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(OPTIONS), default="resnet50")
    ap.add_argument("--batches", default="64,1")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=None,
                    help="default: the git-ignored bench/out/profile_trace_<model>.json")
    ap.add_argument("--trace-dir", help="keep the Chrome traces here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_trace: no CUDA device")
    from ..kernels import autotune
    from ..models import synthetic_quantized
    from ..runtime import Engine, compile_cache

    compile_cache.enable()
    image, classes = SIZES.get(args.model, (224, 1000))
    art = synthetic_quantized(args.model, seed=0, weight_bits=WEIGHT_BITS.get(args.model, 4),
                              batch=1, image=image, classes=classes)
    report = {"model": args.model, "card": autotune.card_name()}
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        for b in (int(v) for v in args.batches.split(",")):
            eng = Engine(art.graph.with_batch_size(b), art.params)
            x = torch.as_tensor(np.random.default_rng(0).standard_normal(
                (b, image, image, 3), dtype=np.float32)).cuda()
            eng.build(image=x)
            r = profile_engine(eng, x, trace_dir, f"profile_trace_{args.model}_b{b}", args.steps)
            report[f"b{b}"] = r
            print(json.dumps({k: v for k, v in r.items()
                              if k not in ("per_node_ms", "top_device_ops", "by_family")}),
                  flush=True)
            for node, ms in list(r["per_node_ms"].items())[:10]:
                print(f"  {ms:10.4f} ms  {node}", flush=True)
            del eng
            torch.cuda.empty_cache()
    out = args.out or str(OUT_DIR / f"profile_trace_{args.model}.json")
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
