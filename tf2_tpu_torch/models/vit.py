"""ViT-B/16 as an IR graph. Attention is built decomposed: a qkv dense, an
``attention_core`` node (per-head QK^T, softmax, PV on the packed qkv
tensor) and an output projection dense, so the projections quantize as
``qdense`` and the core as ``qattention_core`` (int8 QK^T and PV around an
f32 softmax)."""
from __future__ import annotations

from ..graph.ir import Graph, GraphBuilder


def build(batch: int = 1, image: int = 224, classes: int = 1000,
          patch: int = 16, dim: int = 768, depth: int = 12,
          heads: int = 12, mlp_ratio: int = 4,
          cls_token: bool = False) -> Graph:
    """``cls_token=False`` pools the tokens (global average) before the
    head; ``cls_token=True`` prepends a class token (T + 1 tokens) and
    classifies from it, as torchvision's ``vit_b_16``."""
    name = "vit_b16" if (dim, depth) == (768, 12) else f"vit_d{dim}x{depth}"
    b = GraphBuilder(name + ("_cls" if cls_token else ""))
    x = b.input("image", (batch, image, image, 3))
    side = image // patch
    t = side * side
    x = b.conv2d(x, 3, dim, patch, stride=patch, padding="VALID",
                 name="patch_embed")
    x = b.reshape(x, (batch, t, dim), name="tokens", batch_leading=True)
    if cls_token:
        b._param("cls_token", (1, 1, dim))
        x = b.raw("prepend_token", [x], ["cls_token"], name="with_cls")
        t += 1
    b._param("pos_embed", (1, t, dim))
    x = b.raw("bias_add", [x], ["pos_embed"], name="pos_add")
    for i in range(depth):
        h = b.layer_norm(x, dim, name=f"blk{i}_ln1")
        h = b.dense(h, dim, 3 * dim, name=f"blk{i}_qkv")
        h = b.raw("attention_core", [h], name=f"blk{i}_attn",
                  heads=heads, dim=dim)
        h = b.dense(h, dim, dim, name=f"blk{i}_proj")
        x = b.add(x, h, name=f"blk{i}_res1")
        h = b.layer_norm(x, dim, name=f"blk{i}_ln2")
        h = b.dense(h, dim, dim * mlp_ratio, name=f"blk{i}_mlp1")
        h = b.gelu(h, name=f"blk{i}_gelu")
        h = b.dense(h, dim * mlp_ratio, dim, name=f"blk{i}_mlp2")
        x = b.add(x, h, name=f"blk{i}_res2")
    x = b.layer_norm(x, dim, name="ln_final")
    if cls_token:
        x = b.raw("take_token", [x], name="cls_out", idx=0)
    else:
        # mean over tokens: back to an NHWC grid, then global average pool
        x = b.reshape(x, (batch, side, side, dim), name="token_grid",
                      batch_leading=True)
        x = b.global_avgpool(x, name="gap")
    logits = b.dense(x, dim, classes, name="head")
    return b.build(logits, family="vit",
                   flops_per_image=2 * (t * dim * dim * 4 * 3) * depth)
