"""One-call offline pipeline: prune -> fold BN -> patchify -> calibrate ->
quantize -> bias-correct, in the reference's order
(``tf2_tpu/transform/pipeline.py``).

Pruning runs first and physically (``prune.prune_channels``): BN fold,
calibration and quantization all see the smaller net, and the artifact
stores it.
"""
from __future__ import annotations

import time
from typing import Iterable

from ..graph.ir import Graph
from .bias_correct import bias_correct
from .calibrate import calibrate
from .fold import fold_batch_norm
from .prune import PruneSpec, prune_channels
from .quantize import QuantizedArtifact, QuantSpec, quantize_graph


def transform_model(graph: Graph, params: dict, batches: Iterable[dict],
                    qspec: QuantSpec | None = None,
                    pspec: PruneSpec | None = None, device=None,
                    stage_seconds: dict | None = None,
                    ) -> tuple[QuantizedArtifact, Graph, dict]:
    """Returns (quantized artifact, folded f32 graph, folded f32 params).
    The f32 forwards (calibration, bias correction) run on ``device``
    (default: the card; see ``calibrate``). ``stage_seconds``, if given,
    receives the wall seconds of each stage: prune, fold (with the
    patchify), calibrate, quantize (the weight fit), bias_correct."""
    from ..graph.optimize import patchify_stem  # the load passes import the kernels

    qspec = qspec or QuantSpec()
    sec = stage_seconds if stage_seconds is not None else {}
    t = time.perf_counter()
    if pspec is not None and pspec.fraction > 0:
        graph, params, _ = prune_channels(graph, params, pspec)
    sec["prune"], t = time.perf_counter() - t, time.perf_counter()
    # stride == kernel convs (the ViT patch embedding) become layout ops and
    # a dense, exactly, before calibration, so the quantizer sees a dense
    fg, fp = patchify_stem(*fold_batch_norm(graph, params))
    sec["fold"], t = time.perf_counter() - t, time.perf_counter()
    batches = list(batches)
    scales = calibrate(fg, fp, batches, estimator=qspec.act_estimator, device=device)
    sec["calibrate"], t = time.perf_counter() - t, time.perf_counter()
    art = quantize_graph(fg, fp, scales, qspec)
    sec["quantize"], t = time.perf_counter() - t, time.perf_counter()
    if qspec.bias_correct:
        bias_correct(art, fg, fp, batches, device=device)
    sec["bias_correct"] = time.perf_counter() - t
    return art, fg, fp
