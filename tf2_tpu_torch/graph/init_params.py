"""Parameter materialization for IR graphs: deterministic weights drawn from
a seeded ``numpy.random.Generator``.

The rules are those of ``tf2_tpu.graph.init_params``; the numbers are not,
because the two packages draw from different generators. Tests that hold
the port against the reference carry the reference's arrays across instead.
"""
from __future__ import annotations

import numpy as np

from .ir import Graph

# the layer scale (ConvNeXt's gamma) of a synthetic model: the published
# init, 1e-6, is a training start that rounds every residual branch to 0 on
# the int8 grid; this value keeps the branches on it and the residual
# stream inside it (PERF.md, the convnext-t-w4pot configuration)
LAYER_SCALE = 0.1


def init_params(graph: Graph, seed: int = 0) -> dict[str, np.ndarray]:
    """He-normal conv/dense weights, zero biases, identity BN scale/offset,
    BN variance 0.5 + U[0,1) and mean 0.1 * N(0,1) (so BN folding is not a
    no-op), layer scales ``LAYER_SCALE``. Parameters are drawn in sorted
    name order."""
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    for name, spec in sorted(graph.params.items()):
        shape = tuple(spec.shape)
        if name.endswith((".w", ".wqkv", ".wo")):
            fan_in = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
            std = np.float32((2.0 / max(fan_in, 1)) ** 0.5)
            params[name] = std * rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith(".scale"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(".gamma"):
            params[name] = np.full(shape, LAYER_SCALE, np.float32)
        elif name.endswith(".var"):
            params[name] = np.float32(0.5) + rng.random(shape, dtype=np.float32)
        elif name.endswith(".mean"):
            params[name] = np.float32(0.1) * rng.standard_normal(shape, dtype=np.float32)
        else:  # biases, offsets
            params[name] = np.zeros(shape, np.float32)
    return params
