"""IR executor: walks a Graph in order and runs each node's implementation
on torch tensors, eagerly, on the device the tensors live on.

Ops with a kernel (``register_op(..., kernel=True)``) take a ``plain`` flag:
``execute(graph, plain=True)`` runs their plain PyTorch versions instead of
the kernels, on any device, as the reference a kernel run is held against;
``execute(graph, plain_nodes=names)`` runs only the named nodes so (the
Engine's coverage plan: the nodes no kernel takes), and
``execute(graph, library_nodes=names)`` runs the named dense and 1x1 conv
nodes on the ``library`` route (``torch._int_mm``; the Engine's routes,
``kernels/dispatch.py``). An op whose executor waits on the host is
registered with the reason (``host_sync``); ``host_syncs`` lists a graph's.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..kernels import dispatch, qconv, qlrn
from .ir import Graph, Node

Params = Mapping[str, torch.Tensor]

# op name -> (fn(node, params, *inputs[, plain=]), takes_plain)
_OP_IMPLS: dict[str, tuple[Callable, bool]] = {}
# op name -> why its executor waits on the host
_HOST_SYNC: dict[str, str] = {}
_LIBRARY = {"qconv2d": dispatch.qconv2d_library, "qdense": dispatch.qdense_library}


def register_op(name: str, kernel: bool = False, host_sync: str | None = None):
    def deco(fn):
        _OP_IMPLS[name] = (fn, kernel)
        if host_sync:
            _HOST_SYNC[name] = host_sync
        return fn
    return deco


def host_syncs(graph: Graph) -> list[str]:
    """"<node> (<op>): <reason>" for each node whose executor waits on the
    host, which a CUDA graph cannot capture."""
    return [f"{n.name} ({n.op}): {_HOST_SYNC[n.op]}" for n in graph.nodes if n.op in _HOST_SYNC]


def execute(graph: Graph, intermediates: bool = False, plain: bool = False,
            plain_nodes: frozenset[str] = frozenset(),
            library_nodes: frozenset[str] = frozenset()):
    """Return fn(params, **inputs) -> outputs (a tuple if several). With
    ``intermediates=True`` it returns (outputs, dict of every value). The
    nodes named in ``plain_nodes`` run their plain versions, as every node
    does with ``plain=True``; those in ``library_nodes`` (unless plain)
    their ``library`` route."""

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
                if node.name in library_nodes and not plain:
                    env[node.name] = _LIBRARY[node.op](node, params, *args)
                elif takes_plain:
                    env[node.name] = impl(node, params, *args,
                                          plain=plain or node.name in plain_nodes)
                else:
                    env[node.name] = impl(node, params, *args)
        outs = tuple(env[o] for o in graph.outputs)
        result = outs[0] if len(outs) == 1 else outs
        return (result, env) if intermediates else result

    return fn


# f32 ops: the folded model before quantization (``activation_shapes`` runs
# them on ``meta`` tensors) and the fp nodes a quantized graph keeps

@register_op("conv2d")
def _conv2d(node: Node, params, x):
    """NHWC x HWIO in f32, TF padding applied explicitly (it can be
    asymmetric), plus the bias."""
    w = params[node.params[0]]
    kh, kw = w.shape[0], w.shape[1]
    sh, sw = node.attrs.get("strides", [1, 1])
    padding = node.attrs.get("padding", "SAME")
    if not isinstance(padding, str):
        padding = [tuple(p) for p in padding]
    (ph0, ph1), (pw0, pw1) = qconv.resolve_pads(padding, kh, kw, sh, sw,
                                                x.shape[1], x.shape[2])
    xp = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    out = F.conv2d(xp, w.to(x.dtype).permute(3, 2, 0, 1), stride=(sh, sw),
                   groups=node.attrs.get("groups", 1)).permute(0, 2, 3, 1).contiguous()
    if len(node.params) > 1:
        out = out + params[node.params[1]].to(out.dtype)
    return out


@register_op("dense")
def _dense(node: Node, params, x):
    out = torch.matmul(x, params[node.params[0]].to(x.dtype))
    if len(node.params) > 1:
        out = out + params[node.params[1]].to(out.dtype)
    return out


@register_op("layer_norm")
def _layer_norm(node: Node, params, x):
    scale, offset = (params[p].to(torch.float32) for p in node.params)
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + node.attrs.get("eps", 1e-6)) * scale
            + offset).to(x.dtype)


@register_op("attention_core")
def _attention_core(node: Node, params, qkv):
    """Per-head softmax(QK^T / sqrt(hd)) V on a packed (N, T, 3 * dim)
    tensor -> (N, T, dim)."""
    heads, dim = node.attrs["heads"], node.attrs["dim"]
    hd = dim // heads
    n, t, _ = qkv.shape
    q, k, v = (z.reshape(n, t, heads, hd).transpose(1, 2)
               for z in torch.split(qkv, dim, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) / float(hd) ** 0.5
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    return out.transpose(1, 2).reshape(n, t, dim).to(qkv.dtype)


@register_op("bias_add")
def _bias_add(node: Node, params, x):
    return x + params[node.params[0]].to(x.dtype)


@register_op("relu")
def _relu(node, params, x):
    return torch.relu(x)


@register_op("gelu")
def _gelu(node, params, x):
    return dispatch.gelu_tanh(x)


@register_op("add")
def _add(node, params, a, b):
    return a + b


@register_op("reshape")
def _reshape(node: Node, params, x):
    return x.reshape(node.attrs["shape"])


@register_op("flatten")
def _flatten(node, params, x):
    return x.reshape(x.shape[0], -1)


@register_op("transpose")
def _transpose(node: Node, params, x):
    """Copied: the kernels downstream take only contiguous tensors."""
    return x.permute(node.attrs["perm"]).contiguous()


@register_op("pad")
def _pad(node: Node, params, x):
    """Zeros of x's dtype; ``pads`` is (before, after) for each axis."""
    return F.pad(x, [p for pair in reversed(node.attrs["pads"]) for p in pair])


@register_op("space_to_depth")
def _space_to_depth(node: Node, params, x):
    """NHWC block rearrange (H, W, C) -> (H / blk, W / blk, blk * blk * C),
    channels in (dy, dx, c) order, copied."""
    b, h, w, c = x.shape
    blk = node.attrs.get("block", 2)
    x = x.reshape(b, h // blk, blk, w // blk, blk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // blk, w // blk, blk * blk * c)


@register_op("softmax")
def _softmax(node, params, x):
    """Softmax over the last axis in steps that give the same bits on the
    card and the CPU: the exp in float64 rounded once to f32, the row sum
    in float64 rounded once, an IEEE f32 division (``qattention_plain``'s
    recipe). It can differ from XLA's f32 ``jax.nn.softmax`` in the last
    bit."""
    xf = x.to(torch.float32)
    e = torch.exp((xf - xf.amax(dim=-1, keepdim=True)).to(torch.float64)).to(torch.float32)
    return e / e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)


@register_op("prepend_token")
def _prepend_token(node: Node, params, x):
    tok = params[node.params[0]].to(x.dtype)
    return torch.cat([tok.expand(x.shape[0], 1, x.shape[-1]), x], dim=1)


@register_op("take_token")
def _take_token(node: Node, params, x):
    """Copied, as ``transpose``."""
    return x[:, node.attrs.get("idx", 0), :].contiguous()


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


@register_op("lrn")
def _lrn(node, params, x):
    """f32 LRN across channels, by the steps of the plain ``qlrn``: float64
    window sum, ``1 / sqrt``."""
    return qlrn.lrn_f32(x.to(torch.float32), radius=node.attrs.get("radius", 2),
                        alpha=node.attrs.get("alpha", 1e-4),
                        beta=node.attrs.get("beta", 0.75),
                        bias=node.attrs.get("bias", 1.0)).to(x.dtype)


@register_op("concat")
def _concat(node, params, *xs):
    return torch.cat(xs, dim=node.attrs.get("axis", -1))


@register_op("slice_c")
def _slice_c(node, params, x):
    """A channel slice, copied: the kernels downstream take only
    contiguous tensors."""
    return x[..., node.attrs["lo"]:node.attrs["hi"]].contiguous()


@register_op("dropout")
def _dropout(node, params, x):
    return x  # inference: dropout is the identity


@register_op("identity")
def _identity(node, params, x):
    return x
