"""IR executor: walks a Graph in order and runs each node's implementation
on torch tensors, eagerly, on the device the tensors live on.

Ops with a kernel (``register_op(..., kernel=True)``) take the name of what
runs them, ``kernel``: ``execute(graph, plain=True)`` runs their plain
PyTorch versions, on any device, as the reference a kernel run is held
against; ``execute(graph, kernels=plan)`` runs each node the plan names
(``Engine.kernels``, by ``dispatch.kernel_of``) on a kernel, its plain
version or its ``library`` route (``torch._int_mm``).
``execute(graph, gather_nodes=names, gather=fn)`` passes each named node's
output through ``fn`` before any later node reads it (a tp-meshed Engine's
all-gather of the output channels, ``parallel/mesh.py``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..kernels import build, dispatch, qconv, qlrn
from ..runtime import spans
from .ir import Graph, Node

Params = Mapping[str, torch.Tensor]

# op name -> (fn(node, params, *inputs[, kernel=]), takes_kernel)
_OP_IMPLS: dict[str, tuple[Callable, bool]] = {}


def register_op(name: str, kernel: bool = False):
    def deco(fn):
        _OP_IMPLS[name] = (fn, kernel)
        return fn
    return deco


# f32 ops whose result is not one correctly rounded step (sums in an order
# the library chooses, tanh, exp, rsqrt): ``execute(..., wide=True)`` runs
# them in float64 and rounds each output once to f32
WIDE_OPS = frozenset({"conv2d", "dense", "layer_norm", "attention", "attention_core",
                      "gelu", "sigmoid"})


def _widen(v):
    return v.to(torch.float64) if v.dtype == torch.float32 else v


_PLAIN_MODE = False   # utils/debug.plain_mode: every node plain


def set_plain_mode(flag: bool) -> bool:
    """Make every node plain (``True``) or not, process-wide; returns the
    previous setting (``utils/debug.plain_mode`` sets and restores it)."""
    global _PLAIN_MODE
    prev, _PLAIN_MODE = _PLAIN_MODE, bool(flag)
    return prev


def run_node(node: Node, params: Params, *args, kernel: str | None = None):
    """One node's output on its inputs, on ``kernel`` (``dispatch.kernel_of``'s
    answer; None: on the card the executor asks it, elsewhere the node is
    plain). Under ``set_plain_mode(True)`` every
    node takes its plain version, whatever it was asked."""
    if node.op not in _OP_IMPLS:
        raise NotImplementedError(f"op {node.op!r} has no executor")
    impl, takes_kernel = _OP_IMPLS[node.op]
    if not takes_kernel:
        return impl(node, params, *args)
    return impl(node, params, *args, kernel="plain" if _PLAIN_MODE else kernel)


def execute(graph: Graph, intermediates: bool = False, plain: bool = False,
            kernels: Mapping[str, str] | None = None, wide: bool = False,
            gather_nodes: frozenset[str] = frozenset(), gather: Callable | None = None):
    """Return fn(params, **inputs) -> outputs (a tuple if several). With
    ``intermediates=True`` it returns (outputs, dict of every value). Each
    node runs on what ``kernels`` names for it (every node plain with
    ``plain=True``). With ``wide=True`` the ``WIDE_OPS`` nodes take their f32
    inputs and params in float64 and round their output once to f32; every
    other f32 op is already a sequence of correctly rounded steps (or an
    exact f64 sum). The f32 values then agree on the card and the CPU, apart
    from an output whose f64 value lies within its own error of an f32
    rounding boundary (about K * 2^-29 of a K-term sum's outputs): the
    Transform Kit's forwards (``transform/calibrate.py``).
    The outputs of ``gather_nodes`` pass through ``gather``."""
    if gather_nodes and gather is None:
        raise ValueError("gather_nodes given without a gather")
    kernels = kernels or {}

    def fn(params: Params, **inputs):
        env: dict[str, torch.Tensor] = dict(inputs)
        wide_params: dict[str, torch.Tensor] = {}
        for node in graph.nodes:
            args = [env[i] for i in node.inputs]
            widen = wide and node.op in WIDE_OPS
            if widen:
                args = [_widen(a) for a in args]
                for p in node.params:
                    if p not in wide_params:
                        wide_params[p] = _widen(params[p])
            # per-node profiler scope (while a profiler runs): torch.profiler
            # attributes host and device time to "<op>:<node>"
            with spans.mirror(node.op, node.name):
                if widen:
                    out = run_node(node, wide_params, *args)
                    out = out.to(torch.float32) if out.dtype == torch.float64 else out
                else:
                    out = run_node(node, params, *args,
                                   kernel="plain" if plain else kernels.get(node.name))
                env[node.name] = gather(out) if node.name in gather_nodes else out
        outs = tuple(env[o] for o in graph.outputs)
        result = outs[0] if len(outs) == 1 else outs
        return (result, env) if intermediates else result

    return fn


@contextlib.contextmanager
def no_tf32():
    """Within the block, cuDNN convolutions and cuBLAS matmuls take full f32
    (on the card both may otherwise round their inputs to TF32, about 1e-3
    relative); every setting is restored after. The f32 forwards of the
    Transform Kit (calibration, bias correction) run inside it."""
    prev = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


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


@register_op("batch_norm")
def _batch_norm(node: Node, params, x):
    """x * inv + (offset - mean * inv), inv = scale / sqrt(var + eps), the
    square root correctly rounded (``build.sqrt_rn``) and divided into 1
    (the reference's XLA ``rsqrt`` is not correctly rounded)."""
    scale, offset, mean, var = (params[p].to(torch.float32) for p in node.params)
    inv = scale * (build.scalar(1.0, x.device) / build.sqrt_rn(var + node.attrs.get("eps", 1e-5)))
    return (x.to(torch.float32) * inv + (offset - mean * inv)).to(x.dtype)


@register_op("layer_norm")
def _layer_norm(node: Node, params, x):
    """In f32, or in float64 for a float64 x (``execute(wide=True)``)."""
    xf = x if x.dtype == torch.float64 else x.to(torch.float32)
    scale, offset = (params[p].to(xf.dtype) for p in node.params)
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


@register_op("attention")
def _attention(node: Node, params, x):
    """Multi-head self-attention with its projections: x @ wqkv + bqkv, the
    attention core, then @ wo + bo."""
    wqkv, bqkv, wo, bo = (params[p].to(x.dtype) for p in node.params)
    out = _attention_core(node, params, torch.matmul(x, wqkv) + bqkv)
    return torch.matmul(out, wo) + bo


@register_op("bias_add")
def _bias_add(node: Node, params, x):
    return x + params[node.params[0]].to(x.dtype)


@register_op("relu")
def _relu(node, params, x):
    return torch.relu(x)


@register_op("relu6")
def _relu6(node, params, x):
    return torch.clamp(x, 0, 6)


@register_op("sigmoid")
def _sigmoid(node, params, x):
    return torch.sigmoid(x)


@register_op("gelu")
def _gelu(node, params, x):
    return dispatch.gelu_tanh(x)


@register_op("add")
def _add(node, params, a, b):
    return a + b


@register_op("mul")
def _mul(node, params, a, b):
    return a * b


@register_op("layer_scale")
def _layer_scale(node: Node, params, x):
    return x * params[node.params[0]].to(x.dtype)


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


@register_op("avgpool")
def _avgpool(node: Node, params, x):
    """Window mean with TF padding, padded explicitly (it can be
    asymmetric): the window sum in float64 rounded once to f32, divided by
    the count of the window's elements inside the input (a SAME window at
    the border counts fewer), a true f32 division on either device."""
    wh, ww = node.attrs["window"]
    sh, sw = node.attrs["strides"]
    b, h, w, c = x.shape
    (ph0, ph1), (pw0, pw1) = qconv.resolve_pads(
        node.attrs.get("padding", "VALID"), wh, ww, sh, sw, h, w)
    oh = qconv.out_size(h, wh, sh, ph0, ph1)
    ow = qconv.out_size(w, ww, sw, pw0, pw1)
    xp = F.pad(x.to(torch.float64), (0, 0, pw0, pw1, ph0, ph1))
    ones = F.pad(torch.ones(1, h, w, 1, dtype=torch.float64, device=x.device),
                 (0, 0, pw0, pw1, ph0, ph1))
    total = cnt = None
    for dy in range(wh):
        for dx in range(ww):
            win = (slice(None), slice(dy, dy + sh * (oh - 1) + 1, sh),
                   slice(dx, dx + sw * (ow - 1) + 1, sw))
            total = xp[win] if total is None else total + xp[win]
            cnt = ones[win] if cnt is None else cnt + ones[win]
    return (total.to(torch.float32) / cnt.to(torch.float32)).to(x.dtype)


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
