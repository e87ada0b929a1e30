"""The routing sweep and the Engine options' A/B on the card: the port's
counterpart of the reference's ``bench/tune_sweep.py``.

    python -m tf2_tpu_torch.bench.tune_sweep [--models resnet50,googlenet,squeezenet_v1_1]
        [--batches 64,1] [--rounds 2] [--commit-defaults] [--out FILE]

For each model's synthetic artifact (``models.synthetic_quantized``, seed 0,
224x224, 1000 classes) at each batch: ``autotune.tune_graph`` times every
exact route of each distinct conv and dense shape and records the
winners; ``autotune.validate_routes`` holds the routed Engine against
``kernel`` everywhere, both built, and demotes the routes that do not win
end to end. Then each Engine option (``block_fusion``, ``merge_1x1``,
``phase_stem``) that changes the model's graph is timed on against off,
both built (off, on, on, off, ``--rounds`` times; ``Engine.benchmark`` on
the captured forwards), the outputs held equal bit for bit; the default
Engine is also timed before ``build`` (eager). An option should be on by
default where it changes a graph and on every such model wins at every
batch outside the readings' spread (its slowest run faster than the
other's fastest) with equal outputs, and off where it never wins so: the
verdicts. The table is saved (``autotune.table_path``); with
``--commit-defaults`` it becomes the committed default
(``kernels/routing_defaults/``) only when a route other than ``kernel``
survived. Prints one JSON line (the card, the verdicts, the table's
routes off ``kernel``); every reading goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

MODELS = ("resnet50", "googlenet", "squeezenet_v1_1")
OPTIONS = ("block_fusion", "merge_1x1", "phase_stem")


def _bench(engine, x, iters: int) -> list[float]:
    return engine.benchmark(iters=iters, reps=3, image=x)["per_rep_s"]


def option_ab(off, on, x, rounds: int, iters: int) -> dict:
    """Engines with an option off and on (both built) timed in turn, off,
    on, on, off, ``rounds`` times; ms a forward."""
    import torch

    equal = bool(torch.equal(off.run(image=x), on.run(image=x)))
    runs = {"off": [], "on": []}
    for _ in range(rounds):
        for label in ("off", "on", "on", "off"):
            runs[label] += _bench(on if label == "on" else off, x, iters)
    ms = {k: [t * 1e3 for t in v] for k, v in runs.items()}
    return {"off_ms": float(np.median(ms["off"])), "on_ms": float(np.median(ms["on"])),
            "on_wins": max(ms["on"]) < min(ms["off"]),
            "off_wins": max(ms["off"]) < min(ms["on"]), "equal": equal, "readings_ms": ms}


def verdicts(results: dict) -> dict:
    """{option: {"default_on", "changes", "on_wins", "equal"}} from
    ``results``[model][batch]["options"][option] (absent where the option
    leaves the model's graph as it is): on by default where it wins at
    every such cell with equal outputs."""
    out = {}
    for name in OPTIONS:
        cells = [(m, b, r["options"][name]) for m, per_b in results.items()
                 for b, r in per_b.items() if name in r["options"]]
        out[name] = {"changes": sorted({m for m, _, _ in cells}),
                     "on_wins": {f"{m} b{b}": c["on_wins"] for m, b, c in cells},
                     "off_wins": {f"{m} b{b}": c["off_wins"] for m, b, c in cells},
                     "equal": all(c["equal"] for _, _, c in cells),
                     "default_on": bool(cells) and all(c["on_wins"] and c["equal"]
                                                       for _, _, c in cells)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--batches", default="64,1")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--margin", type=float, default=1.10)
    ap.add_argument("--commit-defaults", action="store_true")
    ap.add_argument("--out", default="tune_sweep.json")
    args = ap.parse_args(argv)

    import torch

    from ..kernels import autotune
    from ..models import synthetic_quantized
    from ..runtime import Engine, compile_cache

    compile_cache.enable()
    autotune.reset_table()  # measured afresh, not on top of a saved or committed table
    card = autotune.card_name()
    print(f"card: {card}; table {autotune.table_path()}", flush=True)
    rng = np.random.default_rng(0)
    results: dict = {}
    for model in args.models.split(","):
        art = synthetic_quantized(model, seed=0, batch=64)
        results[model] = {}
        for b in (int(v) for v in args.batches.split(",")):
            g = art.graph.with_batch_size(b)
            x = torch.as_tensor(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)).cuda()
            iters = 20 if b >= 64 else 100
            print(f"=== {model} b{b}: routes ===", flush=True)
            tuned = autotune.tune_graph(g, art.params, iters=iters, verbose=True,
                                        margin=args.margin, card=card)
            valid = autotune.validate_routes(g, art.params, batch_input=x, iters=iters,
                                             verbose=True)
            print(f"{model} b{b} whole-graph: {json.dumps({k: v for k, v in valid.items() if k != 'readings_ms'})}",
                  flush=True)
            default = Engine(g, art.params)
            eager_ms = [t * 1e3 for t in _bench(default, x, iters)]
            default.build(image=x)
            captured_ms = [t * 1e3 for t in _bench(default, x, iters)]
            cell = {"tune": tuned, "validate": valid, "eager_ms": eager_ms,
                    "captured_ms": captured_ms, "options": {}}
            for name in OPTIONS:
                pair = {flag: Engine(g, art.params, **{name: flag}) for flag in (False, True)}
                if pair[False].graph.to_json() == pair[True].graph.to_json():
                    continue
                pair = {flag: default if e.graph.to_json() == default.graph.to_json()
                        else e.build(image=x) for flag, e in pair.items()}
                cell["options"][name] = c = option_ab(pair[False], pair[True], x, args.rounds,
                                                      iters)
                print(f"{model} b{b} {name}: on {c['on_ms']:.4f} ms, off {c['off_ms']:.4f}, "
                      f"on wins {c['on_wins']}, off wins {c['off_wins']}, equal {c['equal']}",
                      flush=True)
                del pair
            results[model][b] = cell
            del default
            torch.cuda.empty_cache()
    autotune.save()
    table = autotune._load()
    off_kernel = {k: v for k, v in table["routes"].items() if v != "kernel"}
    committed = None
    if args.commit_defaults:
        if off_kernel:
            committed = autotune.save_defaults()
        print(f"commit defaults: {committed or 'no route off kernel survived, default left'}",
              flush=True)
    summary = {"card": card, "verdicts": verdicts(results), "routes_off_kernel": off_kernel,
               "committed": committed}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({**summary, "results": results, "table": table}, f, indent=1, default=str)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
