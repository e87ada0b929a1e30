"""Accuracy harness: the port's counterpart of ``eval/accuracy.py``.

    python -m tf2_tpu_torch.eval.accuracy --model resnet50 --wbits 4 [--data DIR]
        [--checkpoint F] [--image N] [--batch 8] [--batches 4] [--device cuda]

Modes:
- ``golden`` (``golden_eval``): the quantized Engine (built on the card,
  eager on the CPU) against the folded FP32 forward on the same weights
  over synthetic batches: relative error, cosine, top-1 agreement. This is
  the accuracy signal without a dataset or a pretrained checkpoint.
- ``detection`` (``detection_eval``, ``--model ssd``): SSD's quantized
  detections scored against the FP32 model's own, VOC AP at IoU 0.5.
- ``imagenet`` (``imagenet_eval``, ``--data DIR``): top-1/top-5 of both
  graphs on ``DIR/*.npz`` shards (``image`` N x H x W x 3 f32 preprocessed,
  ``label`` N) and the top-1 delta against ``GATE_TOP1_DELTA``.

The synthetic images come from one CPU ``torch.Generator`` seeded
``seed + 1`` (``transform/cli.calibration_batches``): the two calibration
batches first, then the evaluation batches, the same on the card and the
CPU. The FP32 forward runs with TF32 off (``graph/execute.no_tf32``).
Prints one JSON object.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

GATE_TOP1_DELTA = 0.5  # percent: the north star's top-1 budget (BASELINE.json)


def golden_metrics(y_fp32, y_quant) -> dict:
    """One batch's agreement of the quantized output with the FP32 one (f32
    arrays of one shape): ``rel_err`` ||yq - yf|| / ||yf||, ``cosine``, and
    for (B, classes) logits ``top1_agreement`` (else None), by the
    reference's formulas (``eval/accuracy.py:51-56``)."""
    yf = np.asarray(y_fp32, dtype=np.float32)
    yq = np.asarray(y_quant, dtype=np.float32)
    return {
        "rel_err": float(np.linalg.norm(yq - yf) / (np.linalg.norm(yf) + 1e-12)),
        "cosine": float((yf.ravel() @ yq.ravel())
                        / (np.linalg.norm(yf) * np.linalg.norm(yq) + 1e-12)),
        "top1_agreement": (float((yf.argmax(-1) == yq.argmax(-1)).mean())
                           if yf.ndim == 2 else None),
    }


def _average_precision(gt: np.ndarray, det: np.ndarray, iou_thresh: float = 0.5) -> float:
    """VOC-style AP of one image-class pair: gt (G, 4); det (D, 5) rows
    [x1, y1, x2, y2, score] sorted by score, descending. Greedy matching at
    ``iou_thresh``, then the area under the precision envelope
    (continuous, not 11-point)."""
    if len(gt) == 0:
        return float(len(det) == 0)
    if len(det) == 0:
        return 0.0
    ix1 = np.maximum(det[:, None, 0], gt[None, :, 0])
    iy1 = np.maximum(det[:, None, 1], gt[None, :, 1])
    ix2 = np.minimum(det[:, None, 2], gt[None, :, 2])
    iy2 = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_d = np.clip(det[:, 2] - det[:, 0], 0, None) * np.clip(det[:, 3] - det[:, 1], 0, None)
    area_g = np.clip(gt[:, 2] - gt[:, 0], 0, None) * np.clip(gt[:, 3] - gt[:, 1], 0, None)
    iou = inter / np.maximum(area_d[:, None] + area_g[None, :] - inter, 1e-9)
    taken = np.zeros(len(gt), bool)
    tp = np.zeros(len(det))
    for i in range(len(det)):
        j = int(np.argmax(np.where(taken, -1.0, iou[i])))
        if iou[i, j] >= iou_thresh and not taken[j]:
            taken[j] = True
            tp[i] = 1
    cum_tp = np.cumsum(tp)
    recall = cum_tp / len(gt)
    precision = cum_tp / (np.arange(len(det)) + 1)
    for i in range(len(precision) - 2, -1, -1):   # the envelope
        precision[i] = max(precision[i], precision[i + 1])
    ap, prev_r = 0.0, 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)


def synthetic_batches(shape, n_calib: int, n_eval: int, seed: int):
    """(calibration batches, evaluation images): ``n_calib + n_eval``
    standard normal batches from ``calibration_batches`` (CPU, seeded
    ``seed + 1``), in that order."""
    from ..transform.cli import calibration_batches

    batches = calibration_batches(shape, n_calib + n_eval, seed)
    return batches[:n_calib], [b["image"] for b in batches[n_calib:]]


def _transformed(model: str, wbits: int, batch: int, image: int, classes: int, seed: int,
                 calib, device, params=None):
    """(artifact, folded FP32 graph, its params) of ``model`` through the
    port's Transform Kit on ``device``; weights ``params`` or
    ``init_params(seed)`` (SSD's priors added)."""
    from ..graph.init_params import init_params
    from ..models import get_model
    from ..transform import QuantSpec, transform_model

    g = get_model(model, batch=batch, image=image, classes=classes)
    if params is None:
        params = init_params(g, seed=seed)
    if model == "ssd":
        from ..models.ssd import init_priors
        params.update(init_priors(g))
    return transform_model(g, params, calib, qspec=QuantSpec(weight_bits=wbits), device=device)


def _forwards(art, fg, fp, device, example):
    """fp32(x), quant(x) -> numpy outputs: the folded FP32 graph by
    ``execute`` on ``device`` with TF32 off, and the artifact's Engine,
    built on ``example`` (captured on the card)."""
    from ..graph.execute import execute, no_tf32
    from ..runtime import Engine
    from ..transform.calibrate import _on

    fp_dev = _on(fp, device)
    fp_fn = execute(fg)
    eng = Engine(art.graph, art.params, device=device).build(image=example)

    def fp32(x):
        with no_tf32():
            return fp_fn(fp_dev, image=torch.as_tensor(x).to(device)).cpu().numpy()

    def quant(x):
        return eng.run(image=torch.as_tensor(x).to(device)).cpu().numpy()

    return fp32, quant


def golden_eval(model: str, wbits: int, batches: int = 4, batch: int = 8, image: int = 224,
                classes: int = 1000, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Quantized against the folded FP32 forward on ``init_params(seed)``
    weights: ``transform_model`` (two calibration batches, ``QuantSpec(
    weight_bits=wbits)``) on ``device``, then ``batches`` synthetic batches
    through both; the means of ``golden_metrics``."""
    from ..runtime.engine import resolve_device

    device = resolve_device(device)
    shape = (batch, image, image, 3)
    calib, xs = synthetic_batches(shape, 2, batches, seed)
    art, fg, fp = _transformed(model, wbits, batch, image, classes, seed, calib, device)
    fp32, quant = _forwards(art, fg, fp, device, xs[0])
    rows = [golden_metrics(fp32(x), quant(x)) for x in xs]
    agree = [r["top1_agreement"] for r in rows if r["top1_agreement"] is not None]
    return {
        "mode": "golden", "model": model, "wbits": wbits,
        "rel_err_mean": sum(r["rel_err"] for r in rows) / len(rows),
        "cosine_mean": sum(r["cosine"] for r in rows) / len(rows),
        "top1_agreement": sum(agree) / len(agree) if agree else None,
    }


def detection_eval(wbits: int = 4, batches: int = 4, batch: int = 2, image: int = 256,
                   classes: int = 21, seed: int = 0, score_thresh: float = 0.05,
                   device: str | torch.device = "cuda") -> dict:
    """SSD's quantized detections scored against the FP32-folded model's
    own post-NMS detections above ``score_thresh`` (no detection dataset
    ships): VOC AP at IoU 0.5 a (image, class) pair the FP32 model
    detects, averaged. The Engine is built (its NMS captured with the rest).
    mAP near 1: quantization kept the detector's behaviour."""
    from ..runtime.engine import resolve_device

    device = resolve_device(device)
    shape = (batch, image, image, 3)
    calib, xs = synthetic_batches(shape, 2, batches, seed)
    art, fg, fp = _transformed("ssd", wbits, batch, image, classes, seed, calib, device)
    fp32, quant = _forwards(art, fg, fp, device, xs[0])
    aps = []
    total_gt = total_det = 0
    for x in xs:
        det_fp, det_q = fp32(x), quant(x)       # (B, M, 6)
        for b in range(det_fp.shape[0]):
            kept = det_fp[b, :, 4] >= score_thresh
            for ci in np.unique(det_fp[b, :, 5][kept]):
                gt_rows = det_fp[b][(det_fp[b, :, 5] == ci) & kept]
                dq = det_q[b][(det_q[b, :, 5] == ci) & (det_q[b, :, 4] >= score_thresh)]
                dq = dq[np.argsort(-dq[:, 4])]
                aps.append(_average_precision(gt_rows[:, :4], dq[:, :5]))
                total_gt += len(gt_rows)
                total_det += len(dq)
    return {
        "mode": "detection_golden", "model": "ssd", "wbits": wbits,
        "map50_vs_fp32": sum(aps) / max(len(aps), 1),
        "n_image_class_pairs": len(aps),
        "fp32_dets": total_gt, "quant_dets": total_det,
    }


def imagenet_eval(model: str, wbits: int, data_dir: str, image: int = 224, batch: int = 32,
                  checkpoint: str | None = None, device: str | torch.device = "cuda") -> dict:
    """Top-1/top-5 of the FP32 and the quantized graph on ``data_dir/*.npz``
    (``image`` N x H x W x 3 f32, preprocessed; ``label`` N), whole batches
    only; weights from ``checkpoint`` (``transform/importers.
    load_checkpoint``) or ``init_params(0)``; calibrated on the first
    shard's first batch. ``pass``: the top-1 delta within
    ``GATE_TOP1_DELTA``."""
    from ..graph.init_params import init_params
    from ..models import get_model
    from ..runtime.engine import resolve_device

    device = resolve_device(device)
    shards = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not shards:
        raise FileNotFoundError(f"no .npz shards in {data_dir}")
    g = get_model(model, batch=batch, image=image)
    if checkpoint:
        from ..transform.importers import load_checkpoint
        params = load_checkpoint(checkpoint, g)
    else:
        params = init_params(g, seed=0)
    first = np.load(shards[0])["image"][:batch]
    calib = [{"image": torch.as_tensor(first)}]
    art, fg, fp = _transformed(model, wbits, batch, image, 1000, 0, calib, device,
                                    params=params)
    fp32, quant = _forwards(art, fg, fp, device, first)

    def run(fn):
        top1 = top5 = n = 0
        for s in shards:
            d = np.load(s)
            imgs, labels = d["image"], d["label"]
            for i in range(0, len(imgs) - batch + 1, batch):
                logits = fn(imgs[i:i + batch])
                lab = labels[i:i + batch]
                top1 += int((logits.argmax(-1) == lab).sum())
                top5 += sum(int(l in t) for l, t in zip(lab, np.argsort(-logits, -1)[:, :5]))
                n += batch
        if not n:
            raise ValueError(f"no whole batch of {batch} in {data_dir}")
        return 100 * top1 / n, 100 * top5 / n

    fp1, fp5 = run(fp32)
    q1, q5 = run(quant)
    return {
        "mode": "imagenet", "model": model, "wbits": wbits,
        "fp32_top1": fp1, "fp32_top5": fp5, "quant_top1": q1, "quant_top5": q5,
        "top1_delta": fp1 - q1, "gate": GATE_TOP1_DELTA, "pass": (fp1 - q1) <= GATE_TOP1_DELTA,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--wbits", type=int, default=4)
    ap.add_argument("--data", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--image", type=int, default=None,
                    help="default 224 (256 for ssd: its heads need 64 | image)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) "
                                                     "or cpu")
    args = ap.parse_args(argv)
    if args.image is None:
        args.image = 256 if args.model == "ssd" else 224
    if args.data:
        out = imagenet_eval(args.model, args.wbits, args.data, image=args.image,
                            batch=args.batch, checkpoint=args.checkpoint, device=args.device)
    elif args.model == "ssd":
        out = detection_eval(wbits=args.wbits, batches=args.batches, batch=args.batch,
                             image=args.image, device=args.device)
    else:
        out = golden_eval(args.model, args.wbits, batches=args.batches, batch=args.batch,
                          image=args.image, device=args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
