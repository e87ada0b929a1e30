"""SqueezeNet v1.1 as an IR graph, per the v1.1 release of Iandola et al.
2016 (conv1 3x3/2 and early pooling)."""
from __future__ import annotations

from ..graph.ir import Graph, GraphBuilder


def _fire(b: GraphBuilder, x: str, cin: int, squeeze: int, expand: int, idx: int) -> tuple[str, int]:
    s = b.conv2d(x, cin, squeeze, 1, name=f"fire{idx}_squeeze")
    s = b.relu(s)
    e1 = b.relu(b.conv2d(s, squeeze, expand, 1, name=f"fire{idx}_e1x1"))
    e3 = b.relu(b.conv2d(s, squeeze, expand, 3, padding="SAME", name=f"fire{idx}_e3x3"))
    return b.concat([e1, e3], axis=-1, name=f"fire{idx}_out"), 2 * expand


def build(batch: int = 1, image: int = 224, classes: int = 1000) -> Graph:
    b = GraphBuilder("squeezenet_v1_1")
    x = b.input("image", (batch, image, image, 3))
    x = b.conv2d(x, 3, 64, 3, stride=2, padding="VALID", name="conv1")
    x = b.relu(x)
    x = b.maxpool(x, 3, 2)
    c = 64
    x, c = _fire(b, x, c, 16, 64, 2)
    x, c = _fire(b, x, c, 16, 64, 3)
    x = b.maxpool(x, 3, 2)
    x, c = _fire(b, x, c, 32, 128, 4)
    x, c = _fire(b, x, c, 32, 128, 5)
    x = b.maxpool(x, 3, 2)
    x, c = _fire(b, x, c, 48, 192, 6)
    x, c = _fire(b, x, c, 48, 192, 7)
    x, c = _fire(b, x, c, 64, 256, 8)
    x, c = _fire(b, x, c, 64, 256, 9)
    x = b.dropout(x)
    x = b.conv2d(x, c, classes, 1, name="conv10")
    x = b.relu(x)
    x = b.global_avgpool(x, name="pool_final")
    logits = b.raw("identity", [x], name="logits")
    return b.build(logits, family="squeezenet", flops_per_image=0.7e9)
