"""Transform Kit CLI: FP32 weights -> quantized artifact, on the card.

    python -m tf2_tpu_torch.transform.cli --model resnet50 --wbits 4 \
        --out DIR [--calib-batches 2 --batch 4 --image 224] [--platform cpu]

Runs prune (``--prune``) -> fold -> calibrate -> quantize -> bias-correct
-> save, and prints one JSON line (the reference CLI's,
``tf2_tpu/transform/cli.py``). Weights come from ``--checkpoint`` (any
format ``importers.load_checkpoint`` reads) or from ``init_params(seed)``.
The f32 forwards of calibration and bias correction run on ``--platform``:
``cuda`` (the default; without a card it raises) or ``cpu``. The
calibration batches are standard normal images from a CPU
``torch.Generator`` seeded ``seed + 1`` (``calibration_batches``), moved to
the device, so one seed gives the same batches on either platform.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def calibration_batches(shape, n: int, seed: int) -> list[dict[str, torch.Tensor]]:
    """``n`` batches {"image": (shape) f32 standard normal} on the CPU, drawn
    in turn from one ``torch.Generator`` seeded ``seed + 1``."""
    gen = torch.Generator().manual_seed(seed + 1)
    return [{"image": torch.randn(tuple(shape), generator=gen, dtype=torch.float32)}
            for _ in range(n)]


def main(argv=None, report: dict | None = None) -> int:
    """``report``, if given, receives ``stage_seconds`` (prune, fold,
    calibrate, quantize, bias_correct, save) and the JSON line's fields."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--wbits", type=int, default=4, choices=(4, 8))
    ap.add_argument("--batch", type=int, default=4, help="calibration batch")
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--estimator", default="percentile",
                    choices=("absmax", "percentile", "mse"))
    ap.add_argument("--checkpoint", default=None,
                    help="fp32 checkpoint (.safetensors, .npz, .pth/.pt/.bin, "
                         ".caffemodel); else init_params(seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prune", type=float, default=0.0)
    ap.add_argument("--no-first-last-w8", action="store_true")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="device of the calibration and bias-correction forwards")
    args = ap.parse_args(argv)

    from ..graph.init_params import init_params
    from ..models import get_model
    from ..runtime.engine import resolve_device
    from . import PruneSpec, QuantSpec, save_quantized, transform_model

    device = resolve_device(args.platform)
    t0 = time.time()
    if args.model == "ssd" and args.classes == 1000:
        args.classes = 21  # SSD's own default (VOC-style)
    g = get_model(args.model, batch=args.batch, image=args.image, classes=args.classes)
    if args.checkpoint:
        from .importers import load_checkpoint
        params = load_checkpoint(args.checkpoint, g)
    else:
        params = init_params(g, seed=args.seed)
    if args.model == "ssd":
        from ..models.ssd import init_priors
        params.update(init_priors(g))
    batches = calibration_batches(g.inputs["image"].shape, args.calib_batches, args.seed)
    qspec = QuantSpec(weight_bits=args.wbits, first_last_w8=not args.no_first_last_w8,
                      act_estimator=args.estimator)
    pspec = PruneSpec(fraction=args.prune) if args.prune > 0 else None
    stages: dict[str, float] = {}
    art, fg, fp = transform_model(g, params, batches, qspec=qspec, pspec=pspec,
                                  device=device, stage_seconds=stages)
    t = time.perf_counter()
    save_quantized(args.out, art)
    stages["save"] = time.perf_counter() - t
    fp_bytes = sum(int(np.prod(v.shape)) * 4 for v in fp.values())
    line = {
        "model": args.model, "wbits": args.wbits, "out": args.out,
        "artifact_mb": round(art.size_bytes() / 1e6, 2),
        "fp32_mb": round(fp_bytes / 1e6, 2),
        "compression": round(fp_bytes / max(art.size_bytes(), 1), 2),
        "seconds": round(time.time() - t0, 1),
    }
    print(json.dumps(line))
    if report is not None:
        report.update(line, stage_seconds=stages)
    return 0


if __name__ == "__main__":
    sys.exit(main())
