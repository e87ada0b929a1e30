"""The port's headline bench: ResNet-50 with W4-PoT weights and int8
activations on one card, one JSON line (the shape of the reference's
``bench.py``, with the port's own metric name).

    python -m tf2_tpu_torch.bench.headline [--calls 5]

It builds the artifact with the port alone (``models.synthetic_quantized``:
random weights from seed 0, BN folded, synthetic activation scales), builds
every kernel (``runtime.compile_cache.enable``), then times the default
Engine, built (one CUDA graph a forward): ``value`` is the median of
``--calls`` spaced ``Engine.benchmark`` calls at batch 64 (each the median
of 3 runs of 20 replays between CUDA events), ``p50_batch1_ms`` the median
of as many calls at batch 1 (100 replays a run). Every sample is printed,
with the card's name and power limit, and, for each Engine option that is
not the default, its batch-64 img/s the same way.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

METRIC = "resnet50_w4pot_a8_cuda_images_per_sec"
BATCH = 64
# Engine options that are not the default, each timed at batch 64
# (block_fusion is the default; merge_1x1 leaves ResNet-50's graph as it is)
OPTIONS = {"phase_stem": {"phase_stem": True}}
TIMING = ("CUDA events around back-to-back replays of the captured forward "
          "(Engine.build): batch 64 20 replays a run, batch 1 100, median of 3 runs a "
          "call; value and p50 the medians of spaced calls")


def result_line(b64_img_s, b1_ms, card: str, options=None, batch: int = BATCH) -> dict:
    """The bench's JSON object from its measurements: ``b64_img_s`` the
    batch-64 img/s of each call, ``b1_ms`` the batch-1 ms a forward of each
    call, ``card`` nvidia-smi's name and power limit, ``options`` {option:
    its batch-64 img/s samples}."""
    out = {"metric": METRIC, "value": round(float(np.median(b64_img_s)), 1), "unit": "img/s",
           "batch": batch, "p50_batch1_ms": round(float(np.median(b1_ms)), 4),
           "device": card, "timing": TIMING,
           "samples_img_s": [round(float(v), 1) for v in b64_img_s],
           "samples_batch1_ms": [round(float(v), 4) for v in b1_ms]}
    for name, vals in (options or {}).items():
        out[f"{name}_img_s"] = round(float(np.median(vals)), 1)
        out[f"{name}_samples_img_s"] = [round(float(v), 1) for v in vals]
    return out


def samples(engine, image, calls: int, iters: int) -> list[dict]:
    """``calls`` spaced ``Engine.benchmark`` calls (3 runs of ``iters``)."""
    out = []
    for _ in range(calls):
        out.append(engine.benchmark(iters=iters, reps=3, image=image))
        time.sleep(0.5)
    return out


def measure(b64_engine, b1_engine, option_engines, x, calls: int):
    """(b64 img/s, b1 ms, {option: b64 img/s}), each a list of ``calls``
    samples, from built Engines on the batch-64 image ``x`` (and its first
    image at batch 1)."""
    b64 = [r["throughput_per_s"] for r in samples(b64_engine, x, calls, 20)]
    b1 = [r["latency_s"] * 1e3 for r in samples(b1_engine, x[:1], calls, 100)]
    options = {k: [r["throughput_per_s"] for r in samples(e, x, calls, 20)]
               for k, e in option_engines.items()}
    return b64, b1, options


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from ..kernels import autotune
    from ..models import synthetic_quantized
    from ..runtime import Engine, compile_cache

    compile_cache.enable()
    art = synthetic_quantized("resnet50", seed=0, batch=BATCH)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)).cuda()
    eng = Engine(art.graph, art.params).build(image=x)
    eng1 = Engine(art.graph.with_batch_size(1), art.params).build(image=x[:1])
    options = {k: Engine(art.graph, art.params, **flags).build(image=x)
               for k, flags in OPTIONS.items()}
    b64, b1, options = measure(eng, eng1, options, x, args.calls)
    print(json.dumps(result_line(b64, b1, autotune.card_name(), options)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
