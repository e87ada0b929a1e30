"""ResNet with bottleneck blocks (He et al., arXiv:1512.03385), v1.5: the
stride on the 3x3 conv, as torchvision's ``resnet50``. The artifact has the
stem and the classifier in int8 and every other conv in 4-bit PoT codes;
each conv's batch norm folded; each block's residual add a ``qadd`` with
the relu."""
from __future__ import annotations

from . import Emitter


def build(cfg: dict, gen, device):
    size, cin = cfg["image_size"], cfg["num_channels"]
    e = Emitter("resnet50", (size, size, cin), cfg)
    bits, edge = cfg["weight_bits"], cfg["first_last_weight_bits"]
    k, stem = cfg["stem_kernel"], cfg["stem_channels"]
    x = e.quantize("image")
    x = e.layer(x, "conv1", (k, k, cin, stem), bits=edge, relu=True, bn=True,
                conv={"strides": [cfg["stem_stride"]] * 2, "padding": "SAME"})
    p = cfg["pool_kernel"]
    x = e.node("maxpool_0", "maxpool", [x], window=[p, p], strides=[cfg["pool_stride"]] * 2,
               padding="SAME")
    c = stem
    for stage, (blocks, mid) in enumerate(zip(cfg["depths"], cfg["bottleneck_widths"])):
        cout = mid * cfg["expansion"]
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            name = f"s{stage + 1}b{i}"

            def conv(x, part, ci, co, kk, s, relu):
                return e.layer(x, f"{name}_{part}", (kk, kk, ci, co), bits=bits, relu=relu,
                               bn=True, conv={"strides": [s, s], "padding": "SAME"})

            short = x
            if stride != 1 or c != cout:
                short = conv(x, "down", c, cout, 1, stride, False)
            y = conv(x, "c1", c, mid, 1, 1, True)
            y = conv(y, "c2", mid, mid, 3, stride, True)
            y = conv(y, "c3", mid, cout, 1, 1, False)
            x = e.node(f"{name}_out", "qadd", [y, short], sa=e.s, sb=e.s, so=e.s, relu=True)
            c = cout
    x = e.node("gap", "global_avgpool", [e.dequantize(x)])
    x = e.layer(e.quantize(x), "fc", (c, cfg["num_classes"]), bits=edge, relu=False)
    return e.finish(gen, device, [e.dequantize(x)],
                    {"family": "resnet", "flops_per_image": 4.1e9, "weight_bits": bits})
