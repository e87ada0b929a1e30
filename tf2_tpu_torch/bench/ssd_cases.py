"""The two SSD score cases of ``bench/ssd_cases.py`` and the bench that
runs them (its :34-106), one copy for the tests and ``chip_smoke.py``.

- ``random``: the artifact as built. Random weights give every class about
  1/21 of the softmax mass, so nearly every anchor clears the 0.01 score
  threshold and the greedy NMS chains run deep: the post-processing's worst
  case.
- ``background``: the same artifact with each conf head's eb (bias / s_out
  on its int8 grid, channel a * classes + c) raised by ``bg_bias / s_out``
  on the background channels and lowered by ``fg_bias / s_out`` on the
  others, pushing the background's softmax mass to about 99% for most
  anchors, as a trained detector's scores are. The backbone is untouched.

    python -m tf2_tpu_torch.bench.ssd_cases [--batch 64] [--bg-bias 8.0]
        [--fg-bias 3.0] [--out FILE]

On the card: SSD W4 at 256x256, 21 classes (the port's CLI artifact,
``models_bench.ensure_artifact``), one eager Engine a case (its NMS waits
on the host, so it is never built): ``img_per_s`` and ``ms_per_batch``
from ``Engine.benchmark``, ``mean_final_dets_per_img`` (score > 0.01), the
card's name and power limit. One JSON line a case; the report goes to
``--out`` (default: the git-ignored ``bench/out/ssd_cases.json``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

CASES = ("random", "background")
OUT_DIR = Path(__file__).with_name("out")   # the default --out's directory, git-ignored


def background_dominated(graph, params, bg_bias: float = 8.0, fg_bias: float = 3.0) -> dict:
    """``params`` with the conf heads' eb shifted (the reference's
    ``representative_bg_dominated`` case). Raises unless the graph has the
    three conf heads."""
    classes = graph.meta.get("classes", 21)
    out = dict(params)
    heads = 0
    for node in graph.nodes:
        if node.op != "qconv2d" or not node.name.startswith("conf"):
            continue
        s_out = float(node.attrs["out_scale"])
        eb = np.array(params[node.params[2]], np.float32)
        eb[0::classes] += bg_bias / s_out
        for c in range(1, classes):
            eb[c::classes] -= fg_bias / s_out
        out[node.params[2]] = eb
        heads += 1
    if heads < 3:
        raise ValueError(f"{heads} conf heads found, expected 3")
    return out


def case_params(case: str, graph, params, bg_bias: float = 8.0, fg_bias: float = 3.0) -> dict:
    """The params of score case ``case`` (one of ``CASES``)."""
    if case == "random":
        return dict(params)
    if case == "background":
        return background_dominated(graph, params, bg_bias, fg_bias)
    raise KeyError(f"unknown SSD score case {case!r}; have {CASES}")


def run_cases(graph, params, batch: int = 64, bg_bias: float = 8.0, fg_bias: float = 3.0,
              iters: int = 10, reps: int = 3, card: str | None = None) -> list[dict]:
    """One row a case of ``CASES``: the artifact (``graph``, ``params``) at
    ``batch`` on an eager Engine on the card, on one standard normal batch
    (a CPU ``torch.Generator`` seeded 0)."""
    import torch

    from ..kernels import autotune
    from ..runtime import Engine

    g = graph.with_batch_size(batch)
    card = card or autotune.card_name()
    x = torch.randn(tuple(g.inputs["image"].shape), generator=torch.Generator().manual_seed(0))
    rows = []
    for case in CASES:
        eng = Engine(g, case_params(case, g, params, bg_bias, fg_bias))
        x_dev = x.to(eng.device)
        dets = eng.run(image=x_dev)
        stats = eng.benchmark(iters=iters, reps=reps, image=x_dev)
        rows.append({"case": case, "batch": batch,
                     "img_per_s": stats["throughput_per_s"],
                     "ms_per_batch": stats["latency_s"] * 1e3,
                     "mean_final_dets_per_img": float((dets[..., 4] > 0.01).sum()) / batch,
                     "card": card})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--bg-bias", type=float, default=8.0,
                    help="f32 logit boost for the background channels")
    ap.add_argument("--fg-bias", type=float, default=3.0,
                    help="f32 logit suppression for the foreground channels")
    ap.add_argument("--out", default=str(OUT_DIR / "ssd_cases.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ssd_cases: no CUDA device")
    from ..runtime import compile_cache
    from ..transform import load_artifact
    from .models_bench import ensure_artifact

    compile_cache.enable()
    graph, params = load_artifact(ensure_artifact("ssd", 4, 256))
    rows = run_cases(graph, params, args.batch, args.bg_bias, args.fg_bias)
    for row in rows:
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"batch": args.batch, "bg_bias": args.bg_bias,
                                          "fg_bias": args.fg_bias, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
