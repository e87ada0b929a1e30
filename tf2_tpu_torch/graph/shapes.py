"""Activation shape inference for IR graphs.

Runs the executor's plain path on ``meta`` tensors with every intermediate
tapped: PyTorch computes each op's output shape without touching data or a
device, and no kernel is launched.
"""
from __future__ import annotations

import numpy as np
import torch

from .execute import execute
from .ir import Graph


def _meta(v) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def activation_shapes(graph: Graph, params=None) -> dict[str, tuple]:
    """Name -> shape for every value (inputs, node outputs) in the graph.
    ``params`` (arrays or tensors) give the weights' shapes; without them
    the graph's own param specs do."""
    ins = {k: torch.empty(tuple(v.shape), dtype=getattr(torch, v.dtype), device="meta")
           for k, v in graph.inputs.items()}
    if params is not None:
        ps = {k: _meta(v) for k, v in params.items()}
    else:
        ps = {k: torch.empty(tuple(v.shape), dtype=getattr(torch, v.dtype), device="meta")
              for k, v in graph.params.items()}
    _, env = execute(graph, intermediates=True, plain=True)(ps, **ins)
    return {k: tuple(v.shape) for k, v in env.items()}
