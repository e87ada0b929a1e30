"""ConvNeXt (Liu et al., "A ConvNet for the 2020s", arXiv:2201.03545), as
the port's Transform Kit quantizes its ``convnext_t``: the 4x4 stride-4 stem
and the 2x2 stride-2 downsamples patchified (layout ops and a dense), the
stem and the classifier int8, every other layer in 4-bit PoT codes; each
block a depthwise ``qconv2d`` (``groups = C``), a ``qlayernorm``, two 1x1
``qconv2d`` around a ``qgelu`` and a ``qadd`` of the residual; the layer
scale folded into the second 1x1 conv: the PoT fit picks a channel's scale
from its largest weight, so a positive gamma leaves the codes and multiplies
the scale; the head a global average pool on the dequantized stream, then
a ``qlayernorm`` and the classifier."""
from __future__ import annotations

import torch

from . import Emitter


def build(cfg: dict, gen, device):
    size, cin, p = cfg["image_size"], cfg["num_channels"], cfg["patch_size"]
    dims, k, ratio = cfg["dims"], cfg["kernel_size"], cfg["mlp_ratio"]
    e = Emitter("convnext_t", (size, size, cin), cfg)
    bits, edge, eps = cfg["weight_bits"], cfg["first_last_weight_bits"], cfg["layer_norm_eps"]

    def norm(x, name, c):
        ps = [e.const(f"{name}.scale", torch.ones(c, device=device)),
              e.const(f"{name}.offset", torch.zeros(c, device=device))]
        return e.node(name, "qlayernorm", [x], ps, eps=eps, s_in=e.s, s_out=e.s)

    def patchify(x, name, side, kk, c):
        x = e.node(f"{name}__p1", "reshape", [x], shape=[1, side, kk, side, kk, c],
                   batch_leading=True)
        x = e.node(f"{name}__pt", "transpose", [x], perm=[0, 1, 3, 2, 4, 5])
        return e.node(f"{name}__p2", "reshape", [x], shape=[1, side, side, kk * kk * c],
                      batch_leading=True)

    def conv(x, name, kshape, groups=1):
        return e.layer(x, name, kshape, bits=bits, relu=False,
                       conv={"strides": [1, 1], "padding": "SAME", "groups": groups})

    side = size // p
    macs = side * side * p * p * cin * dims[0] + dims[-1] * cfg["num_classes"]
    x = patchify("image", "stem", side, p, cin)
    x = e.layer(e.quantize(x), "stem", (p * p * cin, dims[0]), bits=edge, relu=False)
    x = norm(x, "stem_ln", dims[0])
    pw2 = []
    for s, (depth, d) in enumerate(zip(cfg["depths"], dims)):
        if s:
            side //= 2
            x = patchify(norm(x, f"down{s}_ln", dims[s - 1]), f"down{s}", side, 2, dims[s - 1])
            x = e.layer(x, f"down{s}", (4 * dims[s - 1], d), bits=bits, relu=False)
            macs += side * side * 4 * dims[s - 1] * d
        macs += depth * side * side * d * (k * k + 2 * ratio * d)
        for i in range(depth):
            b = f"s{s + 1}b{i}"
            h = norm(conv(x, f"{b}_dw", (k, k, 1, d), groups=d), f"{b}_ln", d)
            h = conv(h, f"{b}_pw1", (1, 1, d, ratio * d))
            h = e.node(f"{b}_gelu", "qgelu", [h], s_in=e.s, s_out=e.s)
            pw2.append(conv(h, f"{b}_pw2", (1, 1, ratio * d, d)))
            x = e.node(f"{b}_add", "qadd", [x, pw2[-1]], sa=e.s, sb=e.s, so=e.s, relu=False)
    x = e.node("gap", "global_avgpool", [e.dequantize(x)])
    x = e.layer(norm(e.quantize(x), "head_ln", dims[-1]), "fc", (dims[-1], cfg["num_classes"]),
                bits=edge, relu=False)
    graph, params = e.finish(gen, device, [e.dequantize(x)],
                             {"family": "convnext", "flops_per_image": 2 * macs,
                              "weight_bits": bits})
    for name in pw2 if params else ():
        params[f"{name}.es"] = params[f"{name}.es"] * float(cfg["layer_scale"])
    return graph, params

