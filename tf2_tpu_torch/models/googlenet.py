"""GoogLeNet (Inception-v1) as an IR graph, per Szegedy et al. 2014: the
main branch with its two LRN layers; the auxiliary classifiers are a
training-time device and are left out of this inference graph."""
from __future__ import annotations

from ..graph.ir import Graph, GraphBuilder

# (1x1, 3x3reduce, 3x3, 5x5reduce, 5x5, pool_proj)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _inception(b: GraphBuilder, x: str, cin: int, cfg, name: str) -> tuple[str, int]:
    c1, r3, c3, r5, c5, pp = cfg
    b1 = b.relu(b.conv2d(x, cin, c1, 1, name=f"{name}_1x1"))
    b3 = b.relu(b.conv2d(x, cin, r3, 1, name=f"{name}_3x3r"))
    b3 = b.relu(b.conv2d(b3, r3, c3, 3, name=f"{name}_3x3"))
    b5 = b.relu(b.conv2d(x, cin, r5, 1, name=f"{name}_5x5r"))
    b5 = b.relu(b.conv2d(b5, r5, c5, 5, name=f"{name}_5x5"))
    bp = b.maxpool(x, 3, 1, padding="SAME", name=f"{name}_pool")
    bp = b.relu(b.conv2d(bp, cin, pp, 1, name=f"{name}_proj"))
    return b.concat([b1, b3, b5, bp], axis=-1, name=f"{name}_out"), c1 + c3 + c5 + pp


def build(batch: int = 1, image: int = 224, classes: int = 1000) -> Graph:
    b = GraphBuilder("googlenet")
    x = b.input("image", (batch, image, image, 3))
    x = b.relu(b.conv2d(x, 3, 64, 7, stride=2, padding="SAME", name="conv1"))
    x = b.maxpool(x, 3, 2, padding="SAME")
    x = b.lrn(x)
    x = b.relu(b.conv2d(x, 64, 64, 1, name="conv2r"))
    x = b.relu(b.conv2d(x, 64, 192, 3, name="conv2"))
    x = b.lrn(x)
    x = b.maxpool(x, 3, 2, padding="SAME")
    c = 192
    for blk in ("3a", "3b"):
        x, c = _inception(b, x, c, _INCEPTION[blk], f"inc{blk}")
    x = b.maxpool(x, 3, 2, padding="SAME")
    for blk in ("4a", "4b", "4c", "4d", "4e"):
        x, c = _inception(b, x, c, _INCEPTION[blk], f"inc{blk}")
    x = b.maxpool(x, 3, 2, padding="SAME")
    for blk in ("5a", "5b"):
        x, c = _inception(b, x, c, _INCEPTION[blk], f"inc{blk}")
    x = b.global_avgpool(x, name="gap")
    x = b.dropout(x, 0.4)
    logits = b.dense(x, c, classes, name="fc")
    return b.build(logits, family="googlenet", flops_per_image=3.0e9)
