"""Vision Transformer (Dosovitskiy et al., arXiv:2010.11929) with a
global-average-pool head in place of the class token (Beyer et al.,
arXiv:2205.01580). The artifact: the patch embedding as a dense layer on
16x16 patches, int8 weights and activations throughout, layer norm, GELU
and the position-embedding add on the int8 stream, each residual add folded
into the epilogue of the dense layer before it."""
from __future__ import annotations

import torch

from . import Emitter


def build(cfg: dict, gen, device):
    size, cin, p = cfg["image_size"], cfg["num_channels"], cfg["patch_size"]
    d, heads, mlp = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    side = size // p
    t = side * side
    e = Emitter("vit_b16", (size, size, cin), cfg)
    bits = cfg["weight_bits"]
    x = e.node("patch_embed__p1", "reshape", ["image"], shape=[1, side, p, side, p, cin],
               batch_leading=True)
    x = e.node("patch_embed__pt", "transpose", [x], perm=[0, 1, 3, 2, 4, 5])
    x = e.node("patch_embed__p2", "reshape", [x], shape=[1, side, side, p * p * cin],
               batch_leading=True)
    x = e.layer(e.quantize(x), "patch_embed", (p * p * cin, d), bits=cfg["first_last_weight_bits"],
                relu=False)
    x = e.node("tokens", "reshape", [x], shape=[1, t, d], batch_leading=True)
    x = e.node("pos_add", "qbias_add", [x], [e.const("pos_add.bq", torch.zeros(
        (1, t, d), device=device))], s_in=e.s, s_out=e.s)
    eps = cfg["layer_norm_eps"]

    def norm(x, name):
        ps = [e.const(f"{name}.scale", torch.ones(d, device=device)),
              e.const(f"{name}.offset", torch.zeros(d, device=device))]
        return e.node(name, "qlayernorm", [x], ps, eps=eps, s_in=e.s, s_out=e.s)

    for i in range(cfg["num_hidden_layers"]):
        h = e.layer(norm(x, f"blk{i}_ln1"), f"blk{i}_qkv", (d, 3 * d), bits=bits, relu=False)
        h = e.node(f"blk{i}_attn", "qattention_core", [h], heads=heads, dim=d, s_in=e.s,
                   s_out=e.s)
        x = e.layer(h, f"blk{i}_proj", (d, d), bits=bits, relu=False, residual=x,
                    node_name=f"blk{i}_res1")
        h = e.layer(norm(x, f"blk{i}_ln2"), f"blk{i}_mlp1", (d, mlp), bits=bits, relu=False)
        h = e.node(f"blk{i}_gelu", "qgelu", [h], s_in=e.s, s_out=e.s)
        x = e.layer(h, f"blk{i}_mlp2", (mlp, d), bits=bits, relu=False, residual=x,
                    node_name=f"blk{i}_res2")
    x = e.node("token_grid", "reshape", [norm(x, "ln_final")], shape=[1, side, side, d],
               batch_leading=True)
    x = e.node("gap", "global_avgpool", [e.dequantize(x)])
    x = e.layer(e.quantize(x), "head", (d, cfg["num_classes"]), bits=cfg["first_last_weight_bits"],
                relu=False)
    flops = 2 * (t * d * d * 4 * 3) * cfg["num_hidden_layers"]
    return e.finish(gen, device, [e.dequantize(x)],
                    {"family": "vit", "flops_per_image": flops, "weight_bits": bits})
