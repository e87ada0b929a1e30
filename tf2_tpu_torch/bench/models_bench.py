"""Multi-model throughput and latency bench over the port's Engine, the
reference's ``bench/models_bench.py`` on the card.

    python -m tf2_tpu_torch.bench.models_bench [--models resnet50,squeezenet_v1_1,...]
        [--batches 1,64] [--wbits 4] [--prune 0.3] [--out FILE]

Makes each model's artifact with the port's Transform Kit CLI
(``python -m tf2_tpu_torch.transform.cli``: ``init_params`` weights,
calibration batch 2, two batches) into a cache under the temporary
directory whose name holds the port's name (``ensure_artifact``; a
cached artifact that older sources made is rebuilt). Then for each batch:
the default Engine, built (one CUDA graph, SSD's NMS included), timed by ``Engine.benchmark`` (CUDA events; 10 forwards a
run at batch > 8, else 64; the median of 3 runs), and the speed of light of
the artifact's graph at that batch (``bench/roofline.analyze``, the data
sheet's peaks). Prints one JSON row a (model, batch), with
the card's name and power limit; ``--out`` appends the rows to a file.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
# the reference's five configurations (BASELINE.md §2): model -> (wbits, image)
BASELINE_CONFIGS = {
    "squeezenet_v1_1": (8, 224),
    "googlenet": (4, 224),
    "resnet50": (4, 224),
    "ssd": (4, 256),
    "vit_b16": (8, 224),
}


def artifact_dir(model: str, wbits: int, image: int, prune: float = 0.0) -> Path:
    name = f"tf2_tpu_torch_art_{model}_w{wbits}_i{image}"
    if prune:
        name += f"_p{int(prune * 100)}"
    return Path(tempfile.gettempdir()) / name


def _stamp(cmd: list[str]) -> str:
    """A digest of the CLI's arguments and the sources that make an
    artifact (the port's models, graph and transform packages): an
    artifact made by other sources is stale."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for sub in ("models", "graph", "transform"):
        for f in sorted((PACKAGE / sub).glob("*.py")):
            h.update(f.read_bytes())
    return f".stamp_{h.hexdigest()[:16]}"


def ensure_artifact(model: str, wbits: int, image: int, prune: float = 0.0,
                    platform: str = "cuda") -> Path:
    """The model's artifact directory (``artifact_dir``), made by the port's
    CLI on ``platform`` unless a current one is there (its stamp, written
    only after the CLI succeeded, matches; a stale one is removed and made
    again). Raises if the CLI fails."""
    art = artifact_dir(model, wbits, image, prune)
    args = ["--model", model, "--wbits", str(wbits), "--batch", "2", "--image", str(image),
            "--calib-batches", "2", "--platform", platform]
    if prune:
        args += ["--prune", str(prune)]
    stamp = art / _stamp(args)
    if (art / "graph.json").exists():
        if stamp.exists():
            return art
        shutil.rmtree(art)
    art.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([sys.executable, "-m", "tf2_tpu_torch.transform.cli", *args,
                        "--out", str(art)], capture_output=True, text=True, timeout=1800,
                       cwd=PACKAGE.parent)
    if r.returncode:
        raise RuntimeError(f"transform CLI failed for {model}:\n{r.stdout}{r.stderr}")
    stamp.write_text("")
    return art


def bench_row(model: str, batch: int, wbits: int, image: int, prune: float, latency_s: float,
              graph, captured: bool, card: str) -> dict:
    """One (model, batch) row from a measured ms a forward and the
    artifact's graph at that batch (its speed of light from
    ``roofline.analyze``, on the data sheet's peaks)."""
    from .roofline import analyze

    roof = analyze(graph)
    ms = latency_s * 1e3
    return {"model": model, "batch": batch, "wbits": wbits, "image": image, "prune": prune,
            "img_per_s": round(batch / latency_s, 1), "ms_per_batch": round(ms, 4),
            "sol_ms": round(roof["sol_ms"], 4), "sol_fraction": round(roof["sol_ms"] / ms, 4),
            "bound": roof["bound"], "peaks": roof["peaks"], "captured": captured,
            "card": card}


def measure(model: str, graph, params, batch: int, wbits: int, image: int, prune: float,
            card: str) -> dict:
    """The row of one model at one batch on the card: the default Engine,
    built, timed by ``Engine.benchmark``."""
    import numpy as np
    import torch

    from ..runtime import Engine

    g = graph.with_batch_size(batch)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        tuple(g.inputs["image"].shape), dtype=np.float32)).cuda()
    eng = Engine(g, params).build(image=x)
    stats = eng.benchmark(iters=10 if batch > 8 else 64, reps=3, image=x)
    return bench_row(model, batch, wbits, image, prune, stats["latency_s"], g, eng.built,
                     card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default=",".join(BASELINE_CONFIGS))
    ap.add_argument("--batches", default="1,64")
    ap.add_argument("--wbits", type=int, default=None,
                    help="override; default per BASELINE_CONFIGS")
    ap.add_argument("--image", type=int, default=None)
    ap.add_argument("--prune", type=float, default=0.0,
                    help="channel-prune fraction before quantization")
    ap.add_argument("--out", default=None, help="append the JSON rows to this file as well")
    args = ap.parse_args(argv)

    from ..kernels.autotune import card_name
    from ..runtime import compile_cache
    from ..transform import load_artifact

    compile_cache.enable()
    card = card_name()
    rows = []
    for model in args.models.split(","):
        wbits, image = BASELINE_CONFIGS.get(model, (4, 224))
        wbits = args.wbits or wbits
        image = args.image or image
        graph, params = load_artifact(str(ensure_artifact(model, wbits, image, args.prune)))
        for b in (int(v) for v in args.batches.split(",")):
            row = measure(model, graph, params, b, wbits, image, args.prune, card)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
