"""ConvNeXt (Liu et al., "A ConvNet for the 2020s", arXiv:2201.03545) as an
IR graph; ``convnext_t`` is ConvNeXt-T, the ``convnext_tiny`` of
facebookresearch/ConvNeXt and of torchvision.

A 4x4 stride-4 patchify stem and a layer norm, then four stages; between
stages a layer norm and a 2x2 stride-2 conv. Each block computes

    x + gamma * pw2(gelu(pw1(ln(dw(x)))))

with ``dw`` a k x k depthwise conv with bias (``groups = C``, SAME), ``ln``
a layer norm over the channels (eps 1e-6), ``pw1`` C -> 4C and ``pw2`` 4C ->
C pointwise layers and ``gamma`` the per-channel layer scale. The head:
global average pool, layer norm, the classifier.

Departures from the published model, none of which changes a shape:
``pw1`` and ``pw2`` are 1x1 convs where the paper writes ``nn.Linear`` on
NHWC (the same arithmetic), so that the quantizer leaves the block's add
as a ``qadd`` of its own (it folds an add only into a ``qdense``); ``gelu``
is the IR's tanh GELU (the paper's is erf); ``gamma`` is a ``layer_scale``
node, which the Transform Kit folds into ``pw2`` (``transform/fold.py``).
The stem and the downsamples are stride == kernel convs, which
``graph.optimize.patchify_stem`` turns into layout ops and a dense.
"""
from __future__ import annotations

from ..graph.ir import Graph, GraphBuilder

CONVNEXT_T = {"depths": (3, 3, 9, 3), "dims": (96, 192, 384, 768)}


def build(batch: int = 1, image: int = 224, classes: int = 1000,
          depths=CONVNEXT_T["depths"], dims=CONVNEXT_T["dims"], kernel: int = 7,
          mlp_ratio: int = 4, patch: int = 4) -> Graph:
    depths, dims = tuple(depths), tuple(dims)
    name = "convnext_t" if (depths, dims) == (CONVNEXT_T["depths"], CONVNEXT_T["dims"]) else \
        "convnext_d" + "-".join(map(str, depths)) + "_w" + "-".join(map(str, dims))
    b = GraphBuilder(name)
    x = b.input("image", (batch, image, image, 3))
    x = b.conv2d(x, 3, dims[0], patch, stride=patch, padding="VALID", name="stem")
    x = b.layer_norm(x, dims[0], name="stem_ln")
    side = image // patch
    macs = side * side * patch * patch * 3 * dims[0]
    for s, (depth, dim) in enumerate(zip(depths, dims)):
        if s:
            x = b.layer_norm(x, dims[s - 1], name=f"down{s}_ln")
            x = b.conv2d(x, dims[s - 1], dim, 2, stride=2, padding="VALID", name=f"down{s}")
            side //= 2
            macs += side * side * 4 * dims[s - 1] * dim
        for i in range(depth):
            p = f"s{s + 1}b{i}"
            h = b.conv2d(x, dim, dim, kernel, padding="SAME", groups=dim, name=f"{p}_dw")
            h = b.layer_norm(h, dim, name=f"{p}_ln")
            h = b.conv2d(h, dim, mlp_ratio * dim, 1, name=f"{p}_pw1")
            h = b.gelu(h, name=f"{p}_gelu")
            h = b.conv2d(h, mlp_ratio * dim, dim, 1, name=f"{p}_pw2")
            h = b.layer_scale(h, dim, name=f"{p}_ls")
            x = b.add(x, h, name=f"{p}_add")
        macs += depth * side * side * dim * (kernel * kernel + 2 * mlp_ratio * dim)
    x = b.global_avgpool(x, name="gap")
    x = b.layer_norm(x, dims[-1], name="head_ln")
    logits = b.dense(x, dims[-1], classes, name="fc")
    macs += dims[-1] * classes
    return b.build(logits, family="convnext", flops_per_image=2 * macs)
