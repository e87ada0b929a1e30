"""Executors for the quantized ops, registered into the graph executor and
implemented by ``kernels.dispatch``."""
from __future__ import annotations

import torch

from ..kernels import dispatch
from .execute import register_op


@register_op("quantize")
def _quantize(node, params, x):
    return dispatch.quantize(x, node.attrs["scale"])


@register_op("dequantize")
def _dequantize(node, params, x):
    return x.to(torch.float32) * node.attrs["scale"]


for _op in ("qconv2d", "qdense", "qattention_core", "qlayernorm", "qgelu", "qblockchain", "qlrn"):
    register_op(_op, kernel=True)(getattr(dispatch, _op))   # each runs the kernel the plan names
for _op in ("qbias_add", "qconcat", "qadd"):
    register_op(_op)(getattr(dispatch, _op))
