"""ResNet-50 W4 at batch 1 and 64 in three whole-graph variants, timed in
context: the port's counterpart of ``bench/b1_context.py``.

    python -m tf2_tpu_torch.bench.b1_context [--batches 1,64] [--rounds 2] [--out FILE]

- ``baseline`` (A): ``Engine(block_fusion=False)``, the reference's graph;
- ``qblockchain`` (B): ``block_fusion=True``, the port's default (the
  bottleneck chains on the chain kernel);
- ``fc_routed`` (C): A with the fc's dense key routed off ``kernel``
  (``library``, or ``kernel_int8`` where that is the one other route
  ``dispatch.dense_choices`` offers), in a routing table held in memory
  only (``autotune.routes_in_memory``), the counterpart of the reference's
  ``fc_pallas``. The table is as before afterwards; the committed
  ``routing_defaults/`` table is never written.

All three are built (one CUDA graph a forward) in one process and timed
by ``Engine.benchmark`` (CUDA events), interleaved: A, B, C, C, B, A, for
``--rounds``. ``chain_exact_frac`` (B against A) and ``fc_exact_frac`` (C
against A) are the shares of equal logits: 1.0 on the card, every route
being exact. The artifact is ``models.synthetic_quantized("resnet50",
seed=0)`` at 224x224, 1000 classes. One JSON line a batch; the report goes
to ``--out`` (default: the git-ignored ``bench/out/b1_context.json``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

OUT_DIR = Path(__file__).with_name("out")   # the default --out's directory, git-ignored
VARIANTS = ("baseline", "qblockchain", "fc_routed")


def fc_routes(graph, params) -> dict[str, str]:
    """{dense key: its route off ``kernel``} of the graph's ``qdense``
    nodes: ``library`` where ``dispatch.dense_choices`` offers it, else its
    one other route."""
    from ..graph.shapes import activation_shapes
    from ..kernels import autotune, dispatch

    shapes = activation_shapes(graph, params)
    out = {}
    for n in graph.nodes:
        if n.op == "qdense":
            others = [r for r in dispatch.dense_choices(n.attrs["wfmt"]) if r != "kernel"]
            if others:
                key = autotune.dense_key(shapes[n.inputs[0]], n.attrs["kshape"], n.attrs["wfmt"])
                out[key] = "library" if "library" in others else others[0]
    return out


def fc_routed(graph, params, device="cuda"):
    """Variant C: ``Engine(block_fusion=False)`` loaded with ``fc_routes``
    over the current table, in memory (the override ``set_use_kernels``
    cleared while it loads). Raises unless a node took the route."""
    from ..kernels import autotune, dispatch
    from ..runtime import Engine

    prev = dispatch.use_kernels()
    dispatch.set_use_kernels(None)
    try:
        with autotune.routes_in_memory(fc_routes(graph, params)):
            eng = Engine(graph, params, device=device, block_fusion=False)
    finally:
        dispatch.set_use_kernels(prev)
    if not eng.routes:
        raise RuntimeError(f"{graph.name}: no dense node took a route off kernel")
    return eng


def variants(graph, params, x, device="cuda") -> dict:
    """A, B and C of ``graph`` (its batch), each built on ``x``."""
    from ..runtime import Engine

    return {"baseline": Engine(graph, params, device=device, block_fusion=False).build(image=x),
            "qblockchain": Engine(graph, params, device=device).build(image=x),
            "fc_routed": fc_routed(graph, params, device).build(image=x)}


def compare(engines: dict, x, rounds: int = 1, iters: int | None = None, reps: int = 3) -> dict:
    """The three variants (``VARIANTS`` -> a built Engine) on ``x``: each
    one's median ms a forward and readings (interleaved A, B, C, C, B, A,
    ``rounds`` times; ``iters`` forwards a reading, 100 at batch 1 and 20
    above by default) and the two exact fractions."""
    import torch

    batch = x.shape[0]
    iters = iters or (100 if batch < 8 else 20)
    outs = {k: engines[k].run(image=x) for k in VARIANTS}
    runs = {k: [] for k in VARIANTS}
    for _ in range(rounds):
        for k in VARIANTS + VARIANTS[::-1]:
            runs[k] += engines[k].benchmark(iters=iters, reps=reps, image=x)["per_rep_s"]
    row = {k: {"ms": float(np.median(v)) * 1e3, "readings_ms": [t * 1e3 for t in v]}
           for k, v in runs.items()}

    def exact(a, b):
        return float((outs[a] == outs[b]).to(torch.float64).mean())

    row.update(batch=batch, chain_exact_frac=exact("qblockchain", "baseline"),
               fc_exact_frac=exact("fc_routed", "baseline"),
               fc_route=sorted(set(engines["fc_routed"].routes.values())))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,64")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(OUT_DIR / "b1_context.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("b1_context: no CUDA device")
    from ..kernels import autotune
    from ..models import synthetic_quantized
    from ..runtime import compile_cache

    compile_cache.enable()
    card = autotune.card_name()
    art = synthetic_quantized("resnet50", seed=0, batch=64)
    report = {"card": card}
    for b in (int(v) for v in args.batches.split(",")):
        g = art.graph.with_batch_size(b)
        x = torch.randn((b, 224, 224, 3), generator=torch.Generator().manual_seed(0)).cuda()
        row = compare(variants(g, art.params, x), x, rounds=args.rounds)
        report[f"b{b}"] = row
        print(json.dumps({"batch": b, "card": card,
                          **{k: row[k]["ms"] for k in VARIANTS},
                          "chain_exact_frac": row["chain_exact_frac"],
                          "fc_exact_frac": row["fc_exact_frac"]}), flush=True)
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
