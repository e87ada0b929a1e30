"""One run of a cell: set-up, the measured window, the metrics and the
check that decides ``correct``.

A traffic mix (``traffic/<mix>.json``) is data that one generator,
``drive``, reads: ``batch`` images a request, taken from the pool in order,
cycling. Without ``rate_per_s`` the loop is closed: the next request is
issued when the last one's logits are on the host. With it the loop is
open: requests fall due at that mean rate, Poisson (``arrival_gaps``), each issued
when it is due or, where the last call has not returned, as soon as it has;
a request's latency runs from when it fell due. The same traffic runs
``WARM_S`` before the window, as set-up (the first seconds of load run
slower on the card). ``--trace 1`` profiles a slice of the window
(``SLICE_FROM`` of the way in, ``SLICE_S`` long) and annotates each call
there (``pb:call``: the Engine call; ``pb:to_host``: the copy of its
logits).
"""
from __future__ import annotations

import gc
import importlib
import math
import os
import random
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch

from . import artifact, counts, images, reference, system, trace
from .manifest import HERE, Cell
from .reference import files as ref_files
from .seeds import derive

KERNELS = HERE / ".cache" / "kernels"
POOL_IMAGES = 1024   # MLPerf Inference's ResNet-50 performance sample set
WARM_S = 2.0
SLICE_FROM, SLICE_S = 0.4, 1.0
N_GAPS = 4096


class Call(NamedTuple):
    """One request of the window: the times (perf_counter ns) it fell due,
    was issued, returned from the Engine and had its logits on the host,
    and the pool batch it asked for."""
    due: int
    t0: int
    t1: int
    t2: int
    batch: int


@dataclass
class Window:
    calls: list = field(default_factory=list)     # Call, in issue order
    outputs: list = field(default_factory=list)   # each call's logits, on the host
    slice: trace.Slice | None = None
    slice_first: int = 0                          # the profiled calls: [first, first + calls)
    slice_calls: int = 0
    slice_wall_s: float = 0.0

    def unprofiled(self) -> list:
        """The calls outside the profiled slice."""
        c, a = self.calls, self.slice_first
        return c[:a] + c[a + self.slice_calls:]


@dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read."""
    cell: Cell
    batch: int
    setup_s: float
    window: Window
    graph: dict
    peak: dict | None

    @property
    def window_s(self) -> float:
        c = self.window.calls
        return (c[-1].t2 - c[0].due) * 1e-9

    @property
    def images(self) -> int:
        return len(self.window.calls) * self.batch


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def arrival_gaps(traffic: dict, seed: int) -> list[float] | None:
    """The seconds between requests falling due in an open loop, None for a
    closed one: ``N_GAPS`` quantiles of the exponential law at
    ``rate_per_s``, the same set for every seed, in an order drawn from
    the seed."""
    rate = traffic.get("rate_per_s")
    if rate is None:
        return None
    g = [-math.log1p(-(i + 0.5) / N_GAPS) / rate for i in range(N_GAPS)]
    random.Random(derive(seed, "arrivals")).shuffle(g)
    return g


def drive(call, batches: list, seconds: float, gaps: list[float] | None = None,
          slice_from: float | None = None, slice_s: float = 0.0,
          device=torch.device("cpu")):
    """The loop over ``batches`` for ``seconds``: closed where ``gaps`` is
    None, else open on those gaps, cycling. Requests due (closed: issued)
    before the deadline are served, so the window ends when the logits of
    the last one reach the host. -> (Window, the profiler or None)."""
    w = Window()
    prof = done = None
    nb = len(batches)
    begin = time.perf_counter_ns()
    deadline = begin + int(seconds * 1e9)
    start = None if slice_from is None else begin + int(slice_from * seconds * 1e9)
    s0 = 0
    due = begin
    i = 0
    while True:
        now = time.perf_counter_ns()
        if gaps is None:
            due = now
        elif i:
            due += int(gaps[(i - 1) % len(gaps)] * 1e9)
        if due >= deadline and i:
            break
        # open loop: sleep, then spin the last 2 ms (a sleep overshoots by 1 ms at times)
        while now < due:
            if due - now > 3_000_000:
                time.sleep((due - now - 2_000_000) * 1e-9)
            now = time.perf_counter_ns()
        if start is not None and prof is None and done is None and now >= start:
            prof, s0, w.slice_first = _profiler(device), now, i
            prof.start()
        elif prof is not None and now - s0 >= slice_s * 1e9:
            prof.stop()
            done, prof = prof, None
            w.slice_calls = i - w.slice_first
            w.slice_wall_s = (time.perf_counter_ns() - s0) * 1e-9
        x = batches[i % nb]
        if prof is not None:
            with torch.profiler.record_function("pb:call"):
                t0 = time.perf_counter_ns()
                out = call(x)
                t1 = time.perf_counter_ns()
            with torch.profiler.record_function("pb:to_host"):
                host = out.cpu()
        else:
            t0 = time.perf_counter_ns()
            out = call(x)
            t1 = time.perf_counter_ns()
            host = out.cpu()
        w.calls.append(Call(t0 if gaps is None else due, t0, t1, time.perf_counter_ns(), i % nb))
        w.outputs.append(host)
        i += 1
    if prof is not None:
        prof.stop()
        done = prof
        w.slice_calls = i - w.slice_first
        w.slice_wall_s = (time.perf_counter_ns() - s0) * 1e-9
    return w, done


def reference_logits(art_dir: Path, pool: torch.Tensor, rows: list[int], device,
                     act_bits: int = 8, block: int = 64) -> torch.Tensor:
    """The reference's logits of the pool's ``rows``, ``block`` rows a
    forward, on the host."""
    graph, arrays = ref_files.load(art_dir)
    params = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    idx = torch.tensor(rows, dtype=torch.long)
    out = []
    with torch.no_grad():
        for lo in range(0, len(rows), block):
            x = pool[idx[lo:lo + block]].to(device)
            out.append(reference.forward(graph, params, x, act_bits).cpu())
    return torch.cat(out)


def out_scale(graph: dict) -> float:
    (name,) = graph["outputs"]
    (node,) = [n for n in graph["nodes"] if n["name"] == name]
    return float(node["attrs"]["scale"])


def compare(got: torch.Tensor, want: torch.Tensor, scale: float) -> dict[str, float]:
    """The widest gap between two sets of logits, in steps of the output
    scale, and the share of logits that differ, in %."""
    gap = (got.to(torch.float64) - want.to(torch.float64)).abs() / scale
    gap = torch.nan_to_num(gap, nan=float("inf"))
    return {"max_gap_codes": float(gap.max()),
            "mismatch_pct": float((gap > 0.5).to(torch.float64).mean() * 100.0)}


def sample(cell: Cell, seed: int, n_calls: int) -> list[int]:
    """The calls whose answers are compared: ``compare_calls`` of the
    window's calls, drawn from the seed."""
    rng = random.Random(derive(seed, "sample"))
    return sorted(rng.sample(range(n_calls), min(cell.traffic["compare_calls"], n_calls)))


def judge(cell: Cell, seed: int, art_dir: Path, pool: torch.Tensor, w: Window,
          device) -> dict[str, float]:
    """The compared numbers of a window: each sampled call's logits against
    the reference's on the same images."""
    b = cell.traffic["batch"]
    picks = sample(cell, seed, len(w.outputs))

    def pool_rows(p):
        return range(w.calls[p].batch * b, (w.calls[p].batch + 1) * b)

    rows = sorted({r for p in picks for r in pool_rows(p)})
    want = reference_logits(art_dir, pool, rows, device)
    at = {r: i for i, r in enumerate(rows)}
    classes = cell.config["num_classes"]
    got = torch.cat([w.outputs[p] if tuple(w.outputs[p].shape) == (b, classes)
                     else torch.full((b, classes), float("nan")) for p in picks])
    ref = torch.cat([want[[at[r] for r in pool_rows(p)]] for p in picks])
    return compare(got, ref, out_scale(ref_files.graph(art_dir)))


def control(cell: Cell, seed: int, art_dir: Path, pool: torch.Tensor,
            device) -> dict[str, float]:
    """The control's numbers: the reference at 4-bit activations in the
    program's place, on ``compare_calls`` of the pool's batches drawn from
    the seed."""
    b = cell.traffic["batch"]
    picks = sample(cell, seed, POOL_IMAGES // b)
    rows = [r for p in picks for r in range(p * b, (p + 1) * b)]
    low = reference_logits(art_dir, pool, rows, device, act_bits=4)
    return compare(low, reference_logits(art_dir, pool, rows, device),
                   out_scale(ref_files.graph(art_dir)))


def setup(cell: Cell, seed: int, device: torch.device):
    """-> (artifact dir, image pool, the pool's batches, the Engine). Each
    step's seconds go to standard error."""
    cfg = cell.config
    t = time.perf_counter()

    def step(name):
        nonlocal t
        now = time.perf_counter()
        print(f"perfbench: set-up {name} {now - t:.3f} s", file=sys.stderr)
        t = now

    if device.type == "cuda":
        torch.cuda.init()
        step("cuda")
        system.build_kernels(KERNELS)
        step("kernels")
    art_dir = artifact.make(cfg, seed, device)
    step("artifact")
    pool = images.pool(seed, POOL_IMAGES, cfg["image_size"], device)
    step("images")
    b = cell.traffic["batch"]
    batches = [pool[i:i + b] for i in range(0, POOL_IMAGES - b + 1, b)]
    eng = system.engine(art_dir, b, device, batches[0])
    step("engine")
    return art_dir, pool, batches, eng


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        elapsed, wrap=None, warm_s: float = WARM_S) -> dict:
    """One run; ``elapsed()`` is the time since the process started.
    ``wrap(call) -> call`` replaces the Engine call (the tests' faults)."""
    art_dir, pool, batches, eng = setup(cell, seed, device)

    def call(x):
        return eng(image=x)

    if wrap is not None:
        call = wrap(call)
    if device.type == "cuda":
        # give back what set-up freed (the pool's draw, the build's eager
        # forward); the graph keeps its own pool, which holds the activations
        torch.cuda.empty_cache()
    g = arrival_gaps(cell.traffic, seed)
    drive(call, batches, warm_s, g)
    if traced:   # the profiler's own start-up, once, outside the window
        with _profiler(device):
            call(batches[0]).cpu()
    if device.type == "cuda":   # the peak of serving, not of set-up
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = elapsed()
    tr = cell.traffic
    w, prof = drive(call, batches, seconds, g, SLICE_FROM if traced else None, SLICE_S, device)
    mem = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            w.slice = trace.read_file(path)
    del eng, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    graph = ref_files.graph(art_dir)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    r = Run(cell, tr["batch"], setup_s, w, graph, counts.peaks(kind))
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        reader = importlib.import_module(f"{__package__}.metrics.{m['name'].split('.')[0]}")
        v = reader.read(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t_ref = time.perf_counter()
    numbers = judge(cell, seed, art_dir, pool, w, device)
    print(f"perfbench: the reference took {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    compared = {k: {"value": v, "limit": cell.limits[k]["limit"]} for k, v in numbers.items()}
    b, classes = tr["batch"], cell.config["num_classes"]
    failed = sum(b for o in w.outputs if tuple(o.shape) != (b, classes))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": mem}
    out = {"correct": all(c["value"] <= c["limit"] for c in compared.values()) and not failed,
           "attempted": r.images, "failed": failed, "metrics": metrics, "device": dev}
    if traced and w.slice is not None:
        dev.update(busy_s=w.slice.device_busy_s, window_s=w.slice.window_s)
        out["breakdown"] = {"device_ops": w.slice.device_ops, "idle_gaps": w.slice.idle_gaps}
    out["compared"] = compared
    return out
