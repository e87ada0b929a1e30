"""IR executor: walks a Graph in order and runs each node's implementation
on torch tensors, eagerly, on the device the tensors live on.

Ops with a kernel (``register_op(..., kernel=True)``) take a ``plain`` flag:
``execute(graph, plain=True)`` runs their plain PyTorch versions instead of
the kernels, on any device, as the reference a kernel run is held against.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..kernels import qconv
from .ir import Graph, Node

Params = Mapping[str, torch.Tensor]

# op name -> (fn(node, params, *inputs[, plain=]), takes_plain)
_OP_IMPLS: dict[str, tuple[Callable, bool]] = {}


def register_op(name: str, kernel: bool = False):
    def deco(fn):
        _OP_IMPLS[name] = (fn, kernel)
        return fn
    return deco


def execute(graph: Graph, intermediates: bool = False, plain: bool = False):
    """Return fn(params, **inputs) -> outputs (a tuple if several). With
    ``intermediates=True`` it returns (outputs, dict of every value)."""

    def fn(params: Params, **inputs):
        env: dict[str, torch.Tensor] = dict(inputs)
        for node in graph.nodes:
            if node.op not in _OP_IMPLS:
                raise NotImplementedError(f"op {node.op!r} has no executor")
            impl, takes_plain = _OP_IMPLS[node.op]
            args = [env[i] for i in node.inputs]
            # per-node profiler scope: torch.profiler attributes host and
            # device time to "<op>:<node>"
            with torch.profiler.record_function(f"{node.op}:{node.name}"):
                if takes_plain:
                    env[node.name] = impl(node, params, *args, plain=plain)
                else:
                    env[node.name] = impl(node, params, *args)
        outs = tuple(env[o] for o in graph.outputs)
        result = outs[0] if len(outs) == 1 else outs
        return (result, env) if intermediates else result

    return fn


@register_op("maxpool")
def _maxpool(node: Node, params, x):
    """Window max with TF padding, which can be asymmetric: pad explicitly
    with the dtype's minimum (-128 for int8), then take the max over the
    window's strided slices."""
    wh, ww = node.attrs["window"]
    sh, sw = node.attrs["strides"]
    b, h, w, c = x.shape
    (ph0, ph1), (pw0, pw1) = qconv.resolve_pads(
        node.attrs.get("padding", "VALID"), wh, ww, sh, sw, h, w)
    lowest = (torch.finfo(x.dtype).min if x.is_floating_point()
              else torch.iinfo(x.dtype).min)
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1), value=lowest)
    oh = qconv.out_size(h, wh, sh, ph0, ph1)
    ow = qconv.out_size(w, ww, sw, pw0, pw1)
    out = None
    for dy in range(wh):
        for dx in range(ww):
            v = xp[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw, :]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


@register_op("global_avgpool")
def _global_avgpool(node, params, x):
    """Mean over H, W. The sum is taken in float64, where it is exact for
    dequantized int8 inputs in any order, and divided by a tensor on x's
    device (a true division; CUDA's ``mean`` multiplies by 1/N): the card
    and the CPU give the same bits. The f32 result can differ from an f32
    mean in the last bit."""
    n = torch.full((), x.shape[1] * x.shape[2], dtype=torch.float64, device=x.device)
    return (x.to(torch.float64).sum(dim=(1, 2)) / n).to(torch.float32).to(x.dtype)
