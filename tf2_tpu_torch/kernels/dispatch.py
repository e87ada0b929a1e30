"""Executors of the fused quantized ops on torch tensors: every conv and
dense layer and every attention core goes through one of the CUDA kernels
(or, with ``plain=True`` or on the CPU, through that kernel's plain
version). The transformer glue (``qlayernorm``, ``qgelu``, ``qbias_add``)
is plain PyTorch on either device, as the reference computes it outside
any kernel, in steps that give the same bits on the card and the CPU.

Each conv and dense node has a route, chosen once at load by the Engine
(``route_conv``, ``route_dense``; the counterparts of the reference's,
``tf2_tpu/kernels/dispatch.py:74-103``), every route exact: ``kernel`` (the
packed pot4 kernel, or the int8 kernel for int8 weights), ``kernel_int8``
(a pot4 node decoded once at load and run on the int8 kernel of its op) or
``library`` (a dense or 1x1 GEMM on ``torch._int_mm`` with the epilogue in
eager f32 steps: ``qdense_library``, ``qconv2d_library``). An override
(``set_use_kernels``) > the measured table (``kernels/autotune.py``) >
``kernel``."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import build, qattention, qblocks, qconv, qlrn as qlrn_kernel, qstem, shift_matmul

ROUTES = ("kernel", "kernel_int8", "library")
_USE_KERNELS: bool | None = None   # None: the table; True / False: forced


def set_use_kernels(flag: bool | None) -> None:
    """Force every conv and dense node to ``kernel`` (True) or to its
    non-kernel route where it has one (False: ``library`` for a dense or
    1x1 GEMM, ``kernel`` elsewhere), or follow the routing table (None).
    Read by the Engine at load: an Engine keeps the routes it was built
    with."""
    global _USE_KERNELS
    _USE_KERNELS = flag


def use_kernels() -> bool | None:
    return _USE_KERNELS


def _route(key: str, choices: tuple[str, ...]) -> str:
    """Override > table (a route the node does not have counts as none) >
    ``kernel``."""
    if _USE_KERNELS is not None:
        return "kernel" if _USE_KERNELS or "library" not in choices else "library"
    from . import autotune
    r = autotune.route(key)
    return r if r in choices else "kernel"


def _is_gemm(kshape, strides, padding, groups: int) -> bool:
    """A 1x1 stride-1 ungrouped conv without padding: ``qconv.fused_qconv2d``
    runs it as a GEMM over the B * H * W pixels."""
    zero_pads = isinstance(padding, str) or all(p == 0 for pair in padding for p in pair)
    return (groups == 1 and zero_pads
            and tuple(kshape[:2]) + tuple(strides) == (1, 1, 1, 1))


def conv_choices(kshape, strides, padding, groups: int, wfmt: str) -> tuple[str, ...]:
    """The exact routes of a conv: ``kernel_int8`` for pot4 weights the
    conv kernels or the GEMM take, ``library`` for a GEMM."""
    gemm = _is_gemm(kshape, strides, padding, groups)
    out = ["kernel"]
    if wfmt == "pot4" and (gemm or qconv.covers(kshape, strides, groups)):
        out.append("kernel_int8")
    if gemm and wfmt in ("pot4", "int8"):
        out.append("library")
    return tuple(out)


def dense_choices(wfmt: str) -> tuple[str, ...]:
    return {"pot4": ROUTES, "int8": ("kernel", "library")}.get(wfmt, ("kernel",))


def route_conv(xshape, kshape, strides, groups: int, wfmt: str, padding="SAME") -> str:
    """The route of a conv node of these shapes (see ``set_use_kernels``)."""
    from . import autotune
    key = autotune.conv_key(xshape, kshape, strides, groups, wfmt)
    return _route(key, conv_choices(kshape, strides, padding, groups, wfmt))


def route_dense(xshape, kshape, wfmt: str) -> str:
    """The route of a dense node of these shapes (see ``set_use_kernels``)."""
    from . import autotune
    return _route(autotune.dense_key(xshape, kshape, wfmt), dense_choices(wfmt))


def route_node(node, xshape) -> str:
    """The route of a ``qconv2d`` or ``qdense`` node on input shape
    ``xshape``; ``kernel`` for any other node."""
    a = node.attrs
    if node.op == "qconv2d":
        padding = a.get("padding", "SAME")
        return route_conv(xshape, a["kshape"], a.get("strides", [1, 1]), a.get("groups", 1),
                          a.get("wfmt"), padding if isinstance(padding, str)
                          else [tuple(p) for p in padding])
    if node.op == "qdense":
        return route_dense(xshape, a["kshape"], a.get("wfmt"))
    return "kernel"


def library_matmul(x_q: torch.Tensor, w_q: torch.Tensor, eff_scale, eff_bias, relu: bool,
                   residual=None) -> torch.Tensor:
    """x_q (M, K) int8 . w_q (K, N) int8 by ``torch._int_mm`` (int32, exact),
    then ``shift_matmul.epilogue``'s f32 steps, each its own operation: the
    bits of ``qmatmul_int8``. ``_int_mm`` takes M > 16 and K, N multiples
    of 8 on the card: X is padded with zero rows, and K and N with zeros,
    as needed (the zoo's K and N need none)."""
    m, k = x_q.shape
    n = w_q.shape[1]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    if (kp, np_) != (k, n):
        w_q = F.pad(w_q, (0, np_ - n, 0, kp - k))
    mp = max(m, 17)
    if (mp, kp) != (m, k):
        x_q = F.pad(x_q, (0, kp - k, 0, mp - m))
    acc = torch._int_mm(x_q.contiguous(), w_q)
    if (mp, np_) != (m, n):
        acc = acc[:m, :n]
    return shift_matmul.epilogue(acc, eff_scale, eff_bias, relu, residual)


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 -> int8: clip(round(x / scale), +-127). The divisor is a tensor
    on x's device (``build.scalar``): a true division on the card too."""
    y = torch.round(x.to(torch.float32) / build.scalar(float(scale), x.device))
    return torch.clamp(y, -127, 127).to(torch.int8)


def pack_w_pairs(x_q: torch.Tensor, pad_w) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, (W + lo + hi) / 2, 2 C): zero-pad W by
    ``pad_w`` = (lo, hi), then each pair of W-pixels into the channels."""
    b, h, w, c = x_q.shape
    lo, hi = pad_w
    return F.pad(x_q, (0, 0, lo, hi)).reshape(b, h, (w + lo + hi) // 2, 2 * c)


def _qconv_wpack2(node, params, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """The W-pair-packed stem (graph/optimize.pack_phase_stem): quantize the
    f32 image, zero-pad W by ``pack_pad_w``, pack each pair of W-pixels into
    the channels, (B, H, W'/2, 2 * cin), then one stride-(2, 1) conv of the
    int8 packed weights with H pads ``pack_pad_h``; on the card the conv
    kernel's (2, 1) entry. A negative pad raises, as the reference's
    ``jnp.pad`` does."""
    if min(node.attrs["pack_pad_w"]) < 0:
        raise ValueError(f"{node.name}: negative W pad {node.attrs['pack_pad_w']}")
    xp = pack_w_pairs(quantize(x, node.attrs["s_in"]), node.attrs["pack_pad_w"])
    kw = dict(kshape=tuple(node.attrs["pack_kshape"]),
              pads=(tuple(node.attrs["pack_pad_h"]), (0, 0)), relu=node.attrs["relu"],
              wfmt="int8")
    w_q, es, eb = (params[p] for p in node.params)
    if plain:
        return qconv.qconv_plain(xp, w_q, es, eb, strides=(2, 1), **kw)
    return qconv.qconv_s2x1(xp, w_q, es, eb, **kw)


def qconv2d(node, params, x_q: torch.Tensor, plain: bool = False) -> torch.Tensor:
    if node.attrs.get("wfmt") == "wpack2":
        return _qconv_wpack2(node, params, x_q, plain)
    if node.attrs.get("wfmt") not in ("pot4", "int8"):
        raise NotImplementedError(f"weight format {node.attrs.get('wfmt')!r} is not ported")
    padding = node.attrs.get("padding", "SAME")
    if not isinstance(padding, str):
        padding = [tuple(p) for p in padding]
    if "s_in" in node.attrs:
        # input quantize fused into the stem (graph/optimize.fuse_stem_quantize).
        # A stem the Engine routed to the stem kernel at load (Engine.stem_plan)
        # holds its weight in that kernel's layout (prepare_weights): the
        # kernel quantizes the image itself
        w = params[node.params[0]]
        if not plain and qstem.prepared_ld(w) is not None:
            return qstem.fused_qstem(x_q, w, params[node.params[1]], params[node.params[2]],
                                     padding=padding, relu=node.attrs["relu"],
                                     scale=node.attrs["s_in"])
        x_q = quantize(x_q, node.attrs["s_in"])
    return qconv.fused_qconv2d(
        x_q, params[node.params[0]], params[node.params[1]], params[node.params[2]],
        strides=tuple(node.attrs.get("strides", [1, 1])), padding=padding,
        groups=node.attrs.get("groups", 1), relu=node.attrs["relu"],
        wfmt=node.attrs["wfmt"], kshape=tuple(node.attrs["kshape"]), plain=plain)


def qdense(node, params, x_q: torch.Tensor, r_q: torch.Tensor | None = None,
            plain: bool = False) -> torch.Tensor:
    """With ``r_q``, the residual folded into the epilogue
    (transform/quantize.py, ``fold_residual``): r_q * radd_scale is added
    after es and eb, before relu and the requant."""
    residual = None
    if r_q is not None:
        residual = (r_q.reshape(-1, r_q.shape[-1]), node.attrs["radd_scale"])
    y = shift_matmul.fused_qmatmul(
        x_q.reshape(-1, x_q.shape[-1]), params[node.params[0]], params[node.params[1]],
        params[node.params[2]], node.attrs["relu"], node.attrs["wfmt"], plain, residual)
    return y.reshape(*x_q.shape[:-1], y.shape[-1])


def qdense_library(node, params, x_q: torch.Tensor, r_q: torch.Tensor | None = None):
    """A dense node on the ``library`` route (``library_matmul``); its
    weight is int8 (decoded at load where it was pot4)."""
    residual = None
    if r_q is not None:
        residual = (r_q.reshape(-1, r_q.shape[-1]), node.attrs["radd_scale"])
    y = library_matmul(x_q.reshape(-1, x_q.shape[-1]), params[node.params[0]],
                       params[node.params[1]], params[node.params[2]], node.attrs["relu"],
                       residual)
    return y.reshape(*x_q.shape[:-1], y.shape[-1])


def qconv2d_library(node, params, x_q: torch.Tensor) -> torch.Tensor:
    """A 1x1 stride-1 conv on the ``library`` route: the GEMM over the
    B * H * W pixels (``library_matmul``)."""
    b, h, w, cin = x_q.shape
    cout = node.attrs["kshape"][-1]
    y = library_matmul(x_q.reshape(b * h * w, cin), params[node.params[0]].reshape(cin, cout),
                       params[node.params[1]], params[node.params[2]], node.attrs["relu"])
    return y.reshape(b, h, w, cout)


def qattention_core(node, params, qkv_q: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The fused int8 attention core (kernels/qattention.py)."""
    return qattention.fused_qattention(qkv_q, heads=node.attrs["heads"], dim=node.attrs["dim"],
                                       s_in=node.attrs["s_in"], s_out=node.attrs["s_out"],
                                       plain=plain)


def _requant(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def qlayernorm(node, params, x_q: torch.Tensor) -> torch.Tensor:
    """LayerNorm on the int8 codes, int8 out. Normalization is scale
    invariant, so the codes normalize directly with eps / s_in^2; the
    affine and the output quantize fold into gamma / s_out and beta / s_out:

        mu  = f32(S1 / D),  var = f32((D * S2 - S1^2) / D^2)
        y   = ((x - mu) * (1 / sqrt(var + f32(eps / s_in^2)))) * (gamma / s_out)
              + beta / s_out

    S1 and S2, the sums of the codes and of their squares, are exact
    integers in any order, and every other step is one IEEE operation (no
    fused multiply-add), so the card and the CPU give the same bits. The
    variance is the exact one where the reference (``tf2_tpu/kernels/
    dispatch.py:433-451``) takes f32 means and ``rsqrt``: they agree to
    within one quantum at rounding boundaries."""
    gamma = params[node.params[0]].to(torch.float32)
    beta = params[node.params[1]].to(torch.float32)
    s_in, s_out = node.attrs["s_in"], node.attrs["s_out"]
    d = x_q.shape[-1]
    dev = x_q.device
    xi = x_q.to(torch.int64)
    s1 = xi.sum(dim=-1, keepdim=True)
    s2 = (xi * xi).sum(dim=-1, keepdim=True)
    mu = (s1.to(torch.float64) / build.scalar(d, dev, torch.float64)).to(torch.float32)
    var = ((d * s2 - s1 * s1).to(torch.float64)
           / build.scalar(d * d, dev, torch.float64)).to(torch.float32)
    eps = build.f32(node.attrs.get("eps", 1e-6) / (s_in * s_in))
    inv = build.scalar(1.0, dev) / build.sqrt_rn(var + eps)
    so = build.scalar(build.f32(s_out), dev)
    y = ((x_q.to(torch.float32) - mu) * inv) * (gamma / so) + beta / so
    return _requant(y)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` in its own f32 op order:
    x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3)))), c = f32(sqrt(2/pi))."""
    c = build.f32(np.sqrt(2 / np.pi))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


@functools.lru_cache(maxsize=256)
def _qgelu_table(s_in: float, s_out: float, device: torch.device) -> torch.Tensor:
    """The int8 output of every int8 input, code + 128 -> code, computed
    once on the CPU in f32 (f32(q) * f32(s_in), gelu, / f32(s_out), round,
    clip), then copied to ``device``."""
    q = torch.arange(-128, 128, dtype=torch.float32)
    y = gelu_tanh(q * build.f32(s_in))
    return _requant(y / torch.tensor(build.f32(s_out))).to(device)


def qgelu(node, params, x_q: torch.Tensor) -> torch.Tensor:
    """dequantize -> gelu -> quantize as one gather from a 256-entry table
    (an int8 input has 255 values): the table is built on the CPU, so every
    device gives its bits."""
    table = _qgelu_table(float(node.attrs["s_in"]), float(node.attrs["s_out"]), x_q.device)
    return table[x_q.to(torch.int64) + 128]


def qbias_add(node, params, x_q: torch.Tensor) -> torch.Tensor:
    """Bias (the ViT position embedding) on the int8 grid: the param is
    b / s_out already, so y = x * (s_in / s_out) + b / s_out, requantized."""
    ratio = node.attrs["s_in"] / node.attrs["s_out"]
    return _requant(x_q.to(torch.float32) * ratio + params[node.params[0]].to(torch.float32))


def chain_blocks(node, params) -> list[dict]:
    """A fused chain of bottleneck blocks (graph/optimize.
    fuse_bottleneck_chains) as the kernel's block dicts: the node's params,
    c1, c2, c3 (and the downsample) of each block in order, reshaped."""
    blocks = []
    it = iter(node.params)
    for battrs in node.attrs["blocks"]:
        cm, cout = battrs["cm"], battrs["cout"]
        convs = [("1", (-1, cm)), ("2", (3, 3, cm, cm)), ("3", (cm, cout))]
        if battrs["down"]:
            convs.append(("d", (-1, cout)))
        blk = {}
        for key, shape in convs:
            blk["w" + key] = params[next(it)].reshape(shape)
            blk["es" + key] = params[next(it)]
            blk["eb" + key] = params[next(it)]
        # a double division on the host, then f32 (as the reference's
        # np.float32(sa / so)): never an f32 division on the device
        blk["sa_over_so"] = battrs["sa"] / battrs["so"]
        blk["sb_over_so"] = battrs["sb"] / battrs["so"]
        blk["relu"] = battrs["relu"]
        blocks.append(blk)
    return blocks


def runs_gemm(node, wfmt: str) -> bool:
    """Does the node run on the GEMM kernel of weight format ``wfmt``
    ("int8": ``qmatmul_int8``, "pot4": ``qmatmul_pot4``)? A dense, or an
    ungrouped 1x1 stride-1 conv without padding (``qconv.fused_qconv2d``'s
    GEMM route), with weights of that format."""
    if node.attrs.get("wfmt") != wfmt:
        return False
    if node.op == "qdense":
        return True
    a = node.attrs
    return node.op == "qconv2d" and _is_gemm(a["kshape"], a.get("strides", (1, 1)),
                                             a.get("padding", "SAME"), a.get("groups", 1))


def prepare_weights(graph, params, stem_nodes=frozenset()) -> dict:
    """The params with every weight the GEMMs and the chain kernel read
    replaced, once, by its K-major copy (``shift_matmul.prepare_weight``:
    the int8 GEMM's W^T rows and the pot4 GEMM's packed code rows;
    ``qblocks.prepare_w2``), and the weight of each stem node named in
    ``stem_nodes`` by the stem kernel's rows (``qstem.prepare_weight``),
    each seen through a view of the param's own shape: one copy of each
    weight, which the kernels read without preparing it and the plain
    versions read as the reference's layout."""
    out = dict(params)
    for node in graph.nodes:
        if node.name in stem_nodes:
            out[node.params[0]] = qstem.prepare_weight(out[node.params[0]])
    names = set()
    for node in graph.nodes:
        if runs_gemm(node, "int8") or runs_gemm(node, "pot4"):
            names.add(node.params[0])
        elif node.op == "qblockchain":
            names.update(node.params[0::3])  # each conv's weight, es, eb in turn
    for name in names:
        w = out[name]
        if w.dim() == 4 and tuple(w.shape[:2]) == (3, 3):  # a chain's 3x3, HWIO
            out[name] = qblocks.prepare_w2(w)
        else:
            out[name] = shift_matmul.prepare_weight(w.reshape(-1, w.shape[-1])).reshape(w.shape)
    return out


def qblockchain(node, params, x_q: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The chain kernel (kernels/qblocks.py) on ``chain_blocks``."""
    return qblocks.fused_qblockchain(x_q, chain_blocks(node, params), plain)


def qlrn(node, params, x_q: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The fused int8 LRN (kernels/qlrn.py)."""
    return qlrn_kernel.fused_qlrn(
        x_q, radius=node.attrs.get("radius", 2), alpha=node.attrs.get("alpha", 1e-4),
        beta=node.attrs.get("beta", 0.75), bias=node.attrs.get("bias", 1.0),
        s_in=node.attrs["s_in"], s_out=node.attrs["s_out"], plain=plain)


def qconcat(node, params, *xs: torch.Tensor) -> torch.Tensor:
    """int8 concat: an input on the output's scale is copied as it is; any
    other is requantized by si/so, a double division on the host used as
    an f32 (as qadd's ratios), never an f32 division on the device."""
    so = node.attrs["out_scale"]
    outs = []
    for x, si in zip(xs, node.attrs["in_scales"]):
        if abs(si - so) < 1e-12:
            outs.append(x)
        else:
            y = torch.round(x.to(torch.float32) * (si / so))
            outs.append(torch.clamp(y, -127, 127).to(torch.int8))
    return torch.cat(outs, dim=node.attrs.get("axis", -1))


def qadd(node, params, a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    sa, sb, so = node.attrs["sa"], node.attrs["sb"], node.attrs["so"]
    y = a_q.to(torch.float32) * (sa / so) + b_q.to(torch.float32) * (sb / so)
    if node.attrs.get("relu"):
        y = torch.clamp_min(y, 0.0)
    return _requant(y)
