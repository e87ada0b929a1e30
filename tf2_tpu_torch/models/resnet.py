"""ResNet-50 as an IR graph (W4-PoT weights, A8 activations after the
transform). Bottleneck layout follows the torchvision v1.5 convention:
the stride sits on the 3x3 conv."""
from __future__ import annotations

from ..graph.ir import Graph, GraphBuilder


def _conv_bn(b: GraphBuilder, x: str, cin: int, cout: int, kernel: int,
             stride: int, name: str, relu: bool = True, padding="SAME") -> str:
    x = b.conv2d(x, cin, cout, kernel, stride=stride, padding=padding,
                 bias=False, name=name)
    x = b.batch_norm(x, cout, name=f"{name}_bn")
    if relu:
        x = b.relu(x, name=f"{name}_relu")
    return x


def _bottleneck(b: GraphBuilder, x: str, cin: int, mid: int, cout: int,
                stride: int, name: str) -> str:
    shortcut = x
    if stride != 1 or cin != cout:
        shortcut = _conv_bn(b, x, cin, cout, 1, stride, f"{name}_down", relu=False)
    y = _conv_bn(b, x, cin, mid, 1, 1, f"{name}_c1")
    y = _conv_bn(b, y, mid, mid, 3, stride, f"{name}_c2")
    y = _conv_bn(b, y, mid, cout, 1, 1, f"{name}_c3", relu=False)
    y = b.add(y, shortcut, name=f"{name}_add")
    return b.relu(y, name=f"{name}_out")


def build(batch: int = 1, image: int = 224, classes: int = 1000,
          depths=(3, 4, 6, 3)) -> Graph:
    b = GraphBuilder("resnet50")
    x = b.input("image", (batch, image, image, 3))
    x = _conv_bn(b, x, 3, 64, 7, 2, "conv1")
    x = b.maxpool(x, 3, 2, padding="SAME")
    cin = 64
    for stage, (blocks, mid) in enumerate(zip(depths, (64, 128, 256, 512))):
        cout = mid * 4
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            x = _bottleneck(b, x, cin, mid, cout, stride, f"s{stage+1}b{i}")
            cin = cout
    x = b.global_avgpool(x, name="gap")
    logits = b.dense(x, cin, classes, name="fc")
    return b.build(logits, family="resnet", flops_per_image=4.1e9)
