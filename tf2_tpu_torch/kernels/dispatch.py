"""Executors of the fused quantized ops on torch tensors: every conv and
dense layer goes through one of the CUDA kernels (or, with ``plain=True``
or on the CPU, through that kernel's plain version)."""
from __future__ import annotations

import torch

from . import build, qblocks, qconv, qlrn as qlrn_kernel, shift_matmul


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 -> int8: clip(round(x / scale), +-127). The divisor is a tensor
    on x's device (``build.scalar``): a true division on the card too."""
    y = torch.round(x.to(torch.float32) / build.scalar(float(scale), x.device))
    return torch.clamp(y, -127, 127).to(torch.int8)


def qconv2d(node, params, x_q: torch.Tensor, plain: bool = False) -> torch.Tensor:
    if node.attrs.get("wfmt") not in ("pot4", "int8"):
        raise NotImplementedError(f"weight format {node.attrs.get('wfmt')!r} is not ported")
    if "s_in" in node.attrs:
        # input quantize fused into the stem (graph/optimize.fuse_stem_quantize)
        x_q = quantize(x_q, node.attrs["s_in"])
    padding = node.attrs.get("padding", "SAME")
    if not isinstance(padding, str):
        padding = [tuple(p) for p in padding]
    return qconv.fused_qconv2d(
        x_q, params[node.params[0]], params[node.params[1]], params[node.params[2]],
        strides=tuple(node.attrs.get("strides", [1, 1])), padding=padding,
        groups=node.attrs.get("groups", 1), relu=node.attrs["relu"],
        wfmt=node.attrs["wfmt"], kshape=tuple(node.attrs["kshape"]), plain=plain)


def qdense(node, params, x_q: torch.Tensor, plain: bool = False) -> torch.Tensor:
    y = shift_matmul.fused_qmatmul(
        x_q.reshape(-1, x_q.shape[-1]), params[node.params[0]], params[node.params[1]],
        params[node.params[2]], node.attrs["relu"], node.attrs["wfmt"], plain)
    return y.reshape(*x_q.shape[:-1], y.shape[-1])


def qblockchain(node, params, x_q: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """A fused chain of bottleneck blocks (graph/optimize.
    fuse_bottleneck_chains): the node's params, c1, c2, c3 (and the
    downsample) of each block in order, become the kernel's block dicts."""
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
    return qblocks.fused_qblockchain(x_q, blocks, plain)


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
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
