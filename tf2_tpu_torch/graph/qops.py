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


@register_op("qconv2d", kernel=True)
def _qconv2d(node, params, x, plain=False):
    return dispatch.qconv2d(node, params, x, plain=plain)


@register_op("qdense", kernel=True)
def _qdense(node, params, x, *residual, plain=False):
    return dispatch.qdense(node, params, x, *residual, plain=plain)


@register_op("qattention_core", kernel=True)
def _qattention_core(node, params, qkv, plain=False):
    return dispatch.qattention_core(node, params, qkv, plain=plain)


@register_op("qlayernorm", kernel=True)
def _qlayernorm(node, params, x, plain=False):
    return dispatch.qlayernorm(node, params, x, plain=plain)


@register_op("qgelu", kernel=True)
def _qgelu(node, params, x, plain=False):
    return dispatch.qgelu(node, params, x, plain=plain)


@register_op("qbias_add")
def _qbias_add(node, params, x):
    return dispatch.qbias_add(node, params, x)


@register_op("qblockchain", kernel=True)
def _qblockchain(node, params, x, plain=False):
    return dispatch.qblockchain(node, params, x, plain=plain)


@register_op("qlrn", kernel=True)
def _qlrn(node, params, x, plain=False):
    return dispatch.qlrn(node, params, x, plain=plain)


@register_op("qconcat")
def _qconcat(node, params, *xs):
    return dispatch.qconcat(node, params, *xs)


@register_op("qadd")
def _qadd(node, params, a, b):
    return dispatch.qadd(node, params, a, b)
