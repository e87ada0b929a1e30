"""Serving bench on the card, the reference's ``bench/serving_bench.py``
over the port: continuous batcher -> built Engine at batch 64 under
synthetic load.

    python -m tf2_tpu_torch.bench.serving_bench [--model resnet50] [--batch 64]
        [--seconds 8] [--clients 24] [--synthetic] [--out FILE]

Rows of the one JSON report it prints (with the card's name and power
limit; a file only where ``--out`` names one):
- ``engine_steady_donate`` / ``_nodonate``: a host loop feeding fresh host
  batches (each copied to the card, then given to the Engine) through the
  built Engine with ``donate_inputs`` on and off, a 2-deep pipeline (a CUDA
  event a forward; the loop waits on the one two forwards back):
  sustained img/s, the donation A/B.
- ``serving``: ``InferenceServer`` + ``ContinuousBatcher`` under N client
  threads submitting single images: sustained img/s, p50/p95/p99 request
  latency, batch occupancy. It includes the Python request handling: the
  end-to-end serving figure, distinct from the Engine's own.
- ``split``: where a full batch's time goes on the serving path, each step
  timed with ``perf_counter`` around synchronised work: the host batch
  assembly (the batcher's zero-padded copy of B requests), the pageable
  copy to the card, the replay (``Engine.__call__``: the copy into the
  static input, the replay, the output's copy), the copy out, and the
  Python plumbing (B futures through a queue, each given its row).

The artifact comes from the port's CLI (``models_bench.ensure_artifact``)
or, with ``--synthetic``, from ``models.synthetic_quantized`` (seed 0).
Every Engine runs on ``device`` (the card unless the caller asks for the
CPU, as the tests do); a timing on the CPU is not a device number.
"""
from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def engine_steady(graph, params, batch: int, seconds: float, donate: bool,
                  device: str = "cuda", engine=None) -> dict:
    """The built Engine (``donate_inputs=donate``) fed fresh host batches
    for ``seconds``: each rotated batch copied to the device and given to
    the Engine, two forwards in flight. ``engine``: such an Engine at
    ``batch``, built (default: a new one on ``device``, built here)."""
    from ..runtime import Engine

    g = graph.with_batch_size(batch)
    iname = next(iter(g.inputs))
    shape = g.inputs[iname].shape
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]
    eng = engine
    if eng is None:
        eng = Engine(g, params, device=device, donate_inputs=donate)
        eng.build(**{iname: torch.from_numpy(batches[0]).to(eng.device)})
    dev = eng.device
    # both arms copy each batch to the device the same way; the donated one
    # frees its copy once the forward is queued
    pending = []
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        x = torch.from_numpy(batches[steps % len(batches)]).to(dev)
        eng(**{iname: x})
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.pop(0).synchronize()
        steps += 1
    _sync(dev)
    dt = time.perf_counter() - t0
    return {"img_per_s": batch * steps / dt, "steps": steps, "seconds": dt, "donate": donate,
            "device": str(dev)}


def serving_load(graph, params, batch: int, seconds: float, clients: int = 24,
                 device: str = "cuda", engine=None) -> dict:
    """``InferenceServer`` at ``batch`` under ``clients`` threads, each
    submitting single images back to back for ``seconds``. ``engine``: an
    Engine at ``batch`` to serve (default: a new donated one on
    ``device``); ``start()`` builds it."""
    from ..runtime import Engine
    from ..serve.server import InferenceServer

    g = graph.with_batch_size(batch)
    eng = engine if engine is not None else Engine(g, params, device=device,
                                                   donate_inputs=True)
    iname = next(iter(g.inputs))
    shape = tuple(g.inputs[iname].shape[1:])
    srv = InferenceServer(eng, batch, input_name=iname, max_wait_s=0.002)
    srv.start()
    srv.predict(np.zeros(shape, np.float32), timeout=600)  # warm the path end to end
    lat: list[float] = []
    lock = threading.Lock()
    stop = threading.Event()
    errors: list[BaseException] = []

    def client(seed):
        x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                srv.predict(x, timeout=60)
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
        except Exception as e:  # reported below: the load fails
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    wall = time.perf_counter() - t0
    st = srv.stats()
    srv.stop()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving_load: a client failed or hung: {errors[:1]}")
    ls = sorted(lat)

    def pct(p):
        return ls[min(len(ls) - 1, int(p * len(ls)))] * 1e3 if ls else None

    return {"img_per_s": len(ls) / wall, "requests": len(ls), "clients": clients,
            "batch": batch, "seconds": wall,
            "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
            "avg_occupancy": st["avg_occupancy"], "batches": st["batches"],
            "captured": st["captured"], "device": str(eng.device)}


def time_split(engine, examples: np.ndarray, steps: int = 10) -> dict:
    """Where a full batch's time goes on the serving path, each step timed
    with ``perf_counter`` around synchronised work, medians over ``steps``
    batches, ms: ``assemble`` (the batcher's zero-padded batch of the B
    ``examples``), ``copy_in`` (pageable host -> device), ``replay``
    (``engine(...)`` on the device tensor: static-input copy, replay,
    output copy), ``copy_out`` (device -> host numpy), ``plumbing`` (B
    futures through a queue, each given its row)."""
    from ..serve.server import to_host

    iname = next(iter(engine.graph.inputs))
    spec = engine.graph.inputs[iname]
    b = spec.shape[0]
    dev = engine.device
    parts: dict[str, list[float]] = {k: [] for k in ("assemble", "copy_in", "replay",
                                                     "copy_out", "plumbing")}
    for step in range(steps + 1):  # the first step warms up, untimed
        t = [time.perf_counter()]
        batch = np.zeros(tuple(spec.shape), np.dtype(spec.dtype))
        for i in range(b):
            batch[i] = examples[i % len(examples)]
        t.append(time.perf_counter())
        x = torch.from_numpy(batch).to(dev)
        _sync(dev)
        t.append(time.perf_counter())
        y = engine(**{iname: x})
        _sync(dev)
        t.append(time.perf_counter())
        out = to_host(y)
        t.append(time.perf_counter())
        q: queue.Queue = queue.Queue()
        futs = [Future() for _ in range(b)]
        for i, f in enumerate(futs):
            q.put((examples[i % len(examples)], f, t[0]))
        for i in range(b):
            q.get_nowait()[1].set_result(tuple(o[i] for o in out) if isinstance(out, tuple)
                                         else out[i])
        for f in futs:
            f.result(0)
        t.append(time.perf_counter())
        if step:
            for k, t0, t1 in zip(parts, t, t[1:]):
                parts[k].append((t1 - t0) * 1e3)
    split = {f"{k}_ms": float(np.median(v)) for k, v in parts.items()}
    split["total_ms"] = sum(split.values())
    split["input_mb"] = batch.nbytes / 1e6
    split["device"] = str(dev)
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--synthetic", action="store_true",
                    help="models.synthetic_quantized (seed 0) instead of the CLI's artifact")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    from ..kernels.autotune import card_name
    from ..runtime import Engine, compile_cache
    from .models_bench import BASELINE_CONFIGS, ensure_artifact

    if not torch.cuda.is_available():
        raise RuntimeError("serving_bench measures a CUDA device; none is available")
    compile_cache.enable()
    wbits, image = BASELINE_CONFIGS.get(args.model, (4, 224))
    if args.synthetic:
        from ..models import synthetic_quantized

        art = synthetic_quantized(args.model, seed=0, weight_bits=wbits, image=image)
        graph, params = art.graph, art.params
    else:
        from ..transform import load_artifact

        graph, params = load_artifact(str(ensure_artifact(args.model, wbits, image)))
    report = {"model": args.model, "batch": args.batch, "card": card_name(),
              "artifact": "synthetic" if args.synthetic else "cli"}
    for donate in (True, False):
        report[f"engine_steady_{'donate' if donate else 'nodonate'}"] = engine_steady(
            graph, params, args.batch, args.seconds, donate)
    report["serving"] = serving_load(graph, params, args.batch, args.seconds, args.clients)
    eng = Engine(graph.with_batch_size(args.batch), params).build()
    iname = next(iter(graph.inputs))
    examples = np.random.default_rng(1).standard_normal(
        (args.batch,) + tuple(graph.inputs[iname].shape[1:]), dtype=np.float32)
    report["split"] = time_split(eng, examples)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
