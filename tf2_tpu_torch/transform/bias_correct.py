"""Post-quantization bias correction: the mean quantization error of each
conv and dense layer folded into its requant bias ``eb``.

Teacher-forced, over the calibration batches, for each ``qconv2d`` /
``qdense`` node in graph order (the reference's method,
``tf2_tpu/transform/bias_correct.py``):

    x_fp = the folded f32 graph's input activation of the layer
    x_q  = quantize(x_fp, s_in)                  # the runtime's input
    y_q  = the node with relu off on x_q, * s_out
    y_fp = the f32 layer's pre-activation output
    eb  += mean over (batch, spatial) of (y_fp - y_q) / s_out, per channel

``y_q`` comes from ``kernels.dispatch.qconv2d`` / ``qdense``: on the card
the conv and GEMM kernels (those no kernel takes, by ``Engine.plan``, their
plain versions), on the CPU the plain versions; the two give the same bits.
Each batch's f32 forward runs once (TF32 off) and is kept for every node;
the error sums are float64 and ``eb`` is rounded once to f32.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from ..graph.ir import Node
from .calibrate import _device, _on, forward_values


def _fp_name(q_input: str) -> str:
    """The folded graph's name of a quantized graph's input value: an
    inserted quantize node is named '<orig>__q'."""
    return q_input[:-3] if q_input.endswith("__q") else q_input


def bias_correct(art, folded_graph, folded_params: Mapping,
                 batches: Iterable[dict], device=None, values=None) -> int:
    """Update the ``eb`` vectors of ``art.params`` in place; returns the
    number of corrected layers. Runs on ``device`` (default: that of the
    folded params if they are tensors, else the card). ``values``, if
    given, holds each batch's f32 forward values (name -> tensor, as
    ``calibrate.forward_values`` gives them) in place of that forward."""
    from ..kernels import dispatch
    from ..runtime.engine import Engine, Limits

    batches = list(batches)
    if not batches:
        return 0
    dev = _device(folded_params, device)
    if values is None:
        fparams = _on(folded_params, dev)
        values = [forward_values(folded_graph, fparams, b) for b in batches]
    envs = [_on(env, dev) for env in values]
    # a fused-relu node is named after the relu: its pre-activation f32
    # value is the conv/dense node's own output
    relu_src = {n.name: n.inputs[0] for n in folded_graph.nodes if n.op == "relu"}
    plan = Engine.plan(art.graph, art.params, Limits.of_card()) if dev.type == "cuda" else {}
    qparams = dispatch.prepare_weights(art.graph, _on(art.params, dev))
    corrected = 0
    with torch.no_grad():
        for node in art.graph.nodes:
            if node.op not in ("qconv2d", "qdense"):
                continue
            s_in = float(node.attrs["in_scale"])
            s_out = float(node.attrs["out_scale"])
            pre = Node(node.name, node.op, node.inputs, node.params, dict(node.attrs, relu=False))
            impl = dispatch.qconv2d if node.op == "qconv2d" else dispatch.qdense
            err_sum, count = None, 0
            for env in envs:
                y_fp = env[relu_src.get(node.name, node.name)].to(torch.float64)
                args = [dispatch.quantize(env[_fp_name(node.inputs[0])], s_in)]
                if len(node.inputs) > 1:
                    # residual-folded qdense (QuantSpec.fold_residual): the
                    # f32 output is the add's, so the replay adds the
                    # quantized residual too
                    s_r = float(node.attrs["radd_scale"]) * s_out
                    args.append(dispatch.quantize(env[_fp_name(node.inputs[1])], s_r))
                y_q = impl(pre, qparams, *args, kernel=plan.get(node.name)).to(torch.float64)
                diff = (y_fp - y_q * s_out).reshape(-1, y_fp.shape[-1])
                err_sum = diff.sum(0) if err_sum is None else err_sum + diff.sum(0)
                count += diff.shape[0]
            eb_name = node.params[2]
            eb = np.asarray(art.params[eb_name], np.float64)
            mean_err = err_sum.cpu().numpy() / count
            art.params[eb_name] = (eb + mean_err / s_out).astype(np.float32)
            qparams[eb_name] = torch.as_tensor(art.params[eb_name]).to(dev)
            corrected += 1
    return corrected
