"""Activation calibration: forward taps on the folded f32 graph.

Each calibration batch runs through ``execute(graph, intermediates=True,
wide=True)`` under ``no_grad`` and with TF32 off (``graph.execute.no_tf32``),
on the device the params give (numpy params: the card, unless ``device``
says otherwise). ``wide``: the convolutions, matmuls and reductions compute
in float64 and round each output once to f32, so the card and the CPU see
the same f32 values and give the same scales (the reference's forward is
XLA's f32; the values agree within its error). Every float value of the
forward (the graph's inputs and each float node output) is reduced to one
statistic per batch, the largest over the batches is kept, and the scale is
``clip / 127``.

Estimators (the reference's, ``tf2_tpu/transform/calibrate.py``):
- ``absmax``      : max of |x|
- ``percentile``  : the ``percentile``-th percentile of |x| over a strided
                    subsample of at most ``_MAX_SAMPLE`` elements, taken in
                    NHWC order: linear interpolation between the two order
                    statistics around rank p / 100 * (n - 1), in
                    ``jnp.percentile``'s f32 steps, on the host
- ``mse``         : the clip in absmax * [0.35 .. 1.0] (``mse_candidates``
                    of them, correctly rounded to f32; the reference's
                    ``jnp.linspace`` can be one ulp off) with the least
                    int8 quantization error summed over the batches (a
                    second pass)
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from ..graph.ir import Graph

_MAX_SAMPLE = 1 << 17  # 128k elements a tensor: plenty for a percentile


def _subsample(v: torch.Tensor) -> torch.Tensor:
    """The flattened f32 tensor, or every ``step``-th element of it where it
    holds more than ``_MAX_SAMPLE``."""
    flat = v.to(torch.float32).reshape(-1)
    n = flat.shape[0]
    if n <= _MAX_SAMPLE:
        return flat
    return flat[::n // _MAX_SAMPLE + 1]


def _percentile(v: torch.Tensor, p: float) -> float:
    """The ``p``-th percentile of ``v``'s elements, linear interpolation in
    ``jnp.percentile``'s f32 steps: rank = f32(p / 100) * (n - 1), then the
    two order statistics around it weighted by (1 - w, w), w = rank -
    floor(rank). The sort runs on v's device (exact), the f32 steps here,
    so the card and the CPU give the same value."""
    f32 = np.float32
    s = torch.sort(v.reshape(-1)).values
    n = s.shape[0]
    rank = f32(f32(p) / f32(100.0)) * f32(n - 1)
    lo = int(np.floor(rank))
    hi = min(int(np.ceil(rank)), n - 1)
    w = f32(rank - f32(lo))
    a, b = (f32(x) for x in s[[lo, hi]].cpu().numpy())
    return float(a * (f32(1.0) - w) + b * w)


def _device(params: Mapping, device) -> torch.device:
    """``device`` if given, else that of the first tensor among ``params``,
    else the card; a card that is asked for and missing raises."""
    from ..runtime.engine import resolve_device
    if device is None:
        device = next((v.device for v in params.values() if isinstance(v, torch.Tensor)),
                      "cuda")
    return resolve_device(device)


def _on(arrays: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    """Arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v)).to(device)
            for k, v in arrays.items()}


def forward_values(graph: Graph, params: Mapping[str, torch.Tensor],
                   batch: Mapping) -> dict[str, torch.Tensor]:
    """Every value of one f32 forward of ``batch`` (the inputs and each
    node's output) on the params' device, under ``no_grad`` with TF32 off."""
    from ..graph.execute import execute, no_tf32  # the executor imports the kernels

    inputs = _on(batch, next(iter(params.values())).device)
    with torch.no_grad(), no_tf32():
        _, env = execute(graph, intermediates=True, wide=True)(params, **inputs)
    return {**inputs, **env}


def calibrate(graph: Graph, params: dict, batches: Iterable[dict],
              estimator: str = "percentile", percentile: float = 99.99,
              mse_candidates: int = 16, device=None) -> dict[str, float]:
    """Run the calibration batches; return each float value's activation
    scale (clip / 127): every float node output and the graph's inputs."""
    if estimator == "absmax" or estimator == "mse":
        red = lambda v: float(v.abs().amax())  # noqa: E731 (mse: pass 1)
    elif estimator == "percentile":
        red = lambda v: _percentile(_subsample(v.abs()), percentile)  # noqa: E731
    else:
        raise ValueError(f"unknown estimator {estimator!r}")
    batch_list = list(batches)
    if not batch_list:
        raise ValueError("calibration requires at least one batch")
    dev_params = _on(params, _device(params, device))
    agg: dict[str, float] = {}
    for batch in batch_list:
        env = forward_values(graph, dev_params, batch)
        for k, v in env.items():
            if v.is_floating_point():
                agg[k] = max(agg.get(k, -np.inf), red(v))
    if estimator == "mse":
        agg = _mse_refine(graph, dev_params, batch_list, agg, mse_candidates)
    return {k: max(v, 1e-12) / 127.0 for k, v in agg.items()}


def _mse_refine(graph: Graph, params, batches, absmax: dict,
                n_cand: int) -> dict[str, float]:
    """Pass 2: for each value, the candidate clip whose int8 quantization
    error (f32 steps: q = clip(round(x / s), +-127), (x - q s)^2), summed in
    float64 over the elements and the batches, is least; s = clip / 127."""
    ratios = np.linspace(0.35, 1.0, n_cand).astype(np.float32)
    clips = {k: np.maximum(np.float32(v), np.float32(1e-12)) * ratios for k, v in absmax.items()}
    total = {k: np.zeros(n_cand) for k in clips}
    for batch in batches:
        env = forward_values(graph, params, batch)
        for k, v in env.items():
            if k not in clips:
                continue
            x = v.to(torch.float32).reshape(-1)
            for i, c in enumerate(clips[k]):
                s = torch.tensor(np.float32(c) / np.float32(127.0), device=x.device)
                q = torch.clamp(torch.round(x / s), -127, 127)
                total[k][i] += float(torch.square(x - q * s).to(torch.float64).mean())
    return {k: float(clips[k][int(np.argmin(total[k]))]) for k in total}
