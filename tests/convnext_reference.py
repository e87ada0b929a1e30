"""A float32 ConvNeXt forward in plain PyTorch, written from the equations
of Liu et al., "A ConvNet for the 2020s" (arXiv:2201.03545), as
facebookresearch/ConvNeXt lays them out: NCHW, the stem a 4x4 stride-4
conv and a channel layer norm, between stages a layer norm and a 2x2
stride-2 conv, each block

    x + gamma * pw2(gelu(pw1(ln(dw(x)))))

(``dw`` a k x k depthwise conv with bias, padding k // 2; ``ln`` a layer
norm over channels; ``pw1``, ``pw2`` linear layers on NHWC), the head a
global average pool, a layer norm and a linear classifier. It imports
nothing of the port, of the reference package or of JAX, and takes its
weights by the IR's names and layouts (HWIO convs, (in, out) dense).
``gelu`` is the paper's erf GELU unless ``gelu="tanh"`` (the IR's).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def forward(params: dict, image: torch.Tensor, depths, dims, kernel: int = 7,
            eps: float = 1e-6, gelu: str = "none") -> torch.Tensor:
    """Logits (N, classes) of NHWC f32 ``image``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def conv(x, name, stride=1, padding=0, groups=1):
        w = params[f"{name}.w"].permute(3, 2, 0, 1)   # HWIO -> OIHW
        return F.conv2d(x, w, params[f"{name}.b"], stride=stride, padding=padding,
                        groups=groups)

    def norm(x, name):   # over the channels of an NCHW tensor
        c = x.shape[1]
        y = F.layer_norm(x.permute(0, 2, 3, 1), (c,), params[f"{name}.scale"],
                         params[f"{name}.offset"], eps)
        return y.permute(0, 3, 1, 2)

    def linear(x, name):
        w = params[f"{name}.w"]
        return x @ w.reshape(-1, w.shape[-1]) + params[f"{name}.b"]

    x = image.permute(0, 3, 1, 2)
    x = norm(conv(x, "stem", stride=4), "stem_ln")
    for s, (depth, dim) in enumerate(zip(depths, dims)):
        if s:
            x = conv(norm(x, f"down{s}_ln"), f"down{s}", stride=2)
        for i in range(depth):
            p = f"s{s + 1}b{i}"
            h = norm(conv(x, f"{p}_dw", padding=kernel // 2, groups=dim), f"{p}_ln")
            h = h.permute(0, 2, 3, 1)
            h = linear(F.gelu(linear(h, f"{p}_pw1"), approximate=gelu), f"{p}_pw2")
            x = x + (params[f"{p}_ls.gamma"] * h).permute(0, 3, 1, 2)
    x = x.mean(dim=(2, 3))
    x = F.layer_norm(x, (dims[-1],), params["head_ln.scale"], params["head_ln.offset"], eps)
    return x @ params["fc.w"] + params["fc.b"]
