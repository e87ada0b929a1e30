"""A whole-graph routing sweep, one key at a time: the port's counterpart
of ``bench/context_sweep.py``.

    python -m tf2_tpu_torch.bench.context_sweep [--model resnet50] [--batches 64,1]
        [--reps 5] [--commit-defaults] [--out FILE]

``bench/tune_sweep.py`` times each conv and dense shape alone and then
validates the winners end to end; this times the whole forward instead,
so fusion, layout and per-call costs are in every reading. For each batch
of the model's synthetic artifact (``models.synthetic_quantized``, seed 0,
224x224, 1000 classes):

1. the base: a built default Engine with every key on ``kernel``;
2. for each key the base Engine's nodes have (a conv that a load pass
   fused into a chain takes ``kernel`` whatever its key's route, so its key
   is not swept) and each other route ``dispatch.conv_choices`` /
   ``dense_choices`` allow, a new built Engine with only that key routed
   there; its delta against the base is the key's (``per_op``: over the
   key's count of nodes);
3. the error: ``torch`` has no counterpart of the reference's
   ``timing.noise_floor_s`` (a TPU relay's dispatch jitter), so it is read
   from the base's own ``Engine.benchmark`` repetitions: half their spread
   (max - min of ``per_rep_s``). A route wins when it beats the base by
   more than twice that, i.e. by more than the base's whole spread;
4. the winners, routed together, are timed once more and kept only if that
   joint Engine beats the base by the same margin. Kept winners (and
   ``kernel`` for the other keys) are recorded with
   ``source="context_sweep"`` and saved to ``autotune.table_path()``.

Every trial's routes live in memory (``autotune.routes_in_memory``), over
a table with every key on ``kernel``. ``--commit-defaults`` then writes
the committed ``routing_defaults/`` table, only when a route other than
``kernel`` survived (as ``bench/tune_sweep.py``). The report goes to
``--out`` (default: the git-ignored ``bench/out/context_sweep.json``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

OUT_DIR = Path(__file__).with_name("out")   # the default --out's directory, git-ignored


def graph_keys(graph, params=None) -> dict[str, int]:
    """Routing key -> its count of ``qconv2d`` and ``qdense`` nodes (the
    reference's ``graph_keys``)."""
    from ..kernels import autotune

    counts: dict[str, int] = {}
    for key, _ in autotune.node_keys(graph, params).values():
        counts[key] = counts.get(key, 0) + 1
    return counts


def swept_keys(keys: dict, names) -> dict[str, tuple[int, tuple[str, ...]]]:
    """{key: (its count of nodes, its routes other than ``kernel``)} of the
    ``autotune.node_keys`` entries whose node is in ``names`` (an Engine's
    graph) and has another route."""
    out: dict[str, tuple[int, tuple[str, ...]]] = {}
    for name, (key, choices) in keys.items():
        others = tuple(r for r in choices if r != "kernel")
        if name in names and others:
            out[key] = (out.get(key, (0,))[0] + 1, others)
    return out


def error_s(per_rep_s) -> float:
    """A reading's error from its own repetitions (``Engine.benchmark``'s
    ``per_rep_s``): half their spread."""
    return (max(per_rep_s) - min(per_rep_s)) / 2


def timed_engine(graph, params, routes: dict[str, str], x, iters: int, reps: int):
    """(a default Engine loaded under ``routes`` in memory, built on ``x``,
    its ``Engine.benchmark``)."""
    from ..kernels import autotune, dispatch
    from ..runtime import Engine

    prev = dispatch.use_kernels()
    dispatch.set_use_kernels(None)
    try:
        with autotune.routes_in_memory(routes):
            eng = Engine(graph, params)
    finally:
        dispatch.set_use_kernels(prev)
    eng.build(image=x)
    return eng, eng.benchmark(iters=iters, reps=reps, image=x)


def sweep(graph, params, x, iters: int | None = None, reps: int = 5,
          verbose: bool = False) -> dict:
    """Steps 1-4 of the module's docstring on ``graph`` (its batch) and
    input ``x``; records and saves kept winners. Returns the batch's
    report."""
    import torch

    from ..kernels import autotune

    iters = iters or (100 if x.shape[0] < 8 else 20)
    keys = autotune.node_keys(graph, params)
    all_kernel = {key: "kernel" for key, _ in keys.values()}
    base_eng, base = timed_engine(graph, params, all_kernel, x, iters, reps)
    want = base_eng.run(image=x)
    swept = swept_keys(keys, base_eng.graph.node_map())
    del base_eng
    t0 = float(np.median(base["per_rep_s"]))
    err = error_s(base["per_rep_s"])
    if verbose:
        print(f"=== b{x.shape[0]}: base {t0 * 1e3:.4f} ms (+-{err * 1e6:.1f} us), "
              f"{len(swept)} of {len(set(all_kernel))} keys swept ===", flush=True)
    entries, winners = {}, {}
    for key, (count, others) in sorted(swept.items()):
        entry = {"count": count, "routes": {}}
        best = None
        for route in others:
            eng, m = timed_engine(graph, params, {**all_kernel, key: route}, x, iters, reps)
            if not torch.equal(eng.run(image=x), want):
                raise RuntimeError(f"{key}: route {route} changed the outputs")
            del eng
            t = float(np.median(m["per_rep_s"]))
            delta = t - t0
            entry["routes"][route] = {"ms": t * 1e3, "graph_delta_us": delta * 1e6,
                                      "per_op_delta_us": delta / count * 1e6}
            if delta < -2 * err and (best is None or t < entry["routes"][best]["ms"] / 1e3):
                best = route
        entry["winner"] = best or "kernel"
        if best:
            winners[key] = best
        entries[key] = entry
        if verbose:
            print(f"{key} x{count}: " + ", ".join(
                f"{r} {v['graph_delta_us']:+.1f} us" for r, v in entry["routes"].items())
                + f" -> {entry['winner']}", flush=True)
    result = {"base_ms": t0 * 1e3, "base_readings_ms": [t * 1e3 for t in base["per_rep_s"]],
              "err_us": err * 1e6, "iters": iters, "reps": reps, "entries": entries,
              "winners": winners, "joint_ms": None, "joint_kept": False}
    if winners:
        eng, mj = timed_engine(graph, params, {**all_kernel, **winners}, x, iters, reps)
        del eng
        tj = float(np.median(mj["per_rep_s"]))
        result.update(joint_ms=tj * 1e3, joint_kept=tj < t0 - 2 * err)
        if verbose:
            print(f"joint ({len(winners)}): {tj * 1e3:.4f} ms against {t0 * 1e3:.4f} -> "
                  f"{'kept' if result['joint_kept'] else 'dropped'}", flush=True)
        if result["joint_kept"]:
            for key, entry in entries.items():
                route = winners.get(key, "kernel")
                detail = {"kernel_ms": t0 * 1e3, "count": entry["count"], "err_us": err * 1e6,
                          "source": "context_sweep", "card": base["device"],
                          **{f"{r}_ms": v["ms"] for r, v in entry["routes"].items()}}
                autotune.record(key, route, detail)
            autotune.save()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batches", default="64,1")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--commit-defaults", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR / "context_sweep.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("context_sweep: no CUDA device")
    from ..kernels import autotune
    from ..models import synthetic_quantized
    from ..runtime import compile_cache

    compile_cache.enable()
    card = autotune.card_name()
    art = synthetic_quantized(args.model, seed=0, batch=64)
    results = {}
    for b in (int(v) for v in args.batches.split(",")):
        x = torch.randn((b, 224, 224, 3), generator=torch.Generator().manual_seed(0)).cuda()
        results[f"b{b}"] = sweep(art.graph.with_batch_size(b), art.params, x, reps=args.reps,
                                 verbose=True)
        torch.cuda.empty_cache()
    survived = any(r["joint_kept"] for r in results.values())
    committed = autotune.save_defaults() if args.commit_defaults and survived else None
    print(json.dumps({"card": card, "winners": {b: r["winners"] for b, r in results.items()},
                      "kept": {b: r["joint_kept"] for b, r in results.items()},
                      "committed": committed}), flush=True)
    report = {"model": args.model, "card": card, "table": autotune.table_path(),
              "committed": committed, **results}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
