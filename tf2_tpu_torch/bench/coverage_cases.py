"""Graphs outside the zoo with nodes the port's kernels do not take, for
the Engine's coverage plan (``Engine.plan``): ``chip_smoke.py`` phase 15,
tests/test_torch_coverage.py (against the reference) and
tests/test_torch_cuda.py.

- ``conv_graph``: a small CNN whose middle convs are a depthwise 3x3
  (``groups = cin``), a ``groups=2`` 3x3, a 3x3 at stride 3 and a 3x3 at
  stride (1, 2): the shapes the reference sends to XLA
  (``tf2_tpu/kernels/dispatch.py:191-251``) and the conv kernels do not
  take. Its stem, a pointwise conv and the classifier do have kernels.
- ``tiny_vit_hd24``: a ViT whose heads are 24 wide (dim 48, 2 heads), which
  the attention kernel does not take (hd a multiple of 16).
- ``stem_graph``: a CNN whose image stem is a k x k stride-2 conv that the
  stem kernel's ``covers`` takes and its plan has no launch for (k 9, or
  cout 288): the Engine keeps the quantize and the stride-2 conv kernel,
  and ``qstem.fused_qstem`` takes the same two passes (``TWO_PASS``).
"""
from __future__ import annotations

# the conv_graph nodes, after quantization (each conv takes its relu's
# name), that no conv kernel takes
CONV_PLAIN = frozenset({"dw3x3", "g2_3x3", "s3_3x3", "s12_3x3"})


def conv_graph(builder, batch: int = 2, image: int = 32, classes: int = 10):
    """The graph, built with ``builder`` (a ``GraphBuilder`` class: the
    port's, or the reference's in the tests)."""
    b = builder("coverage_convs")
    x = b.input("image", (batch, image, image, 3))
    convs = [  # (name, cin, cout, kernel, stride, padding, groups)
        ("stem", 3, 16, 3, 2, "SAME", 1),
        ("dw3x3", 16, 16, 3, 1, "SAME", 16),
        ("pw1x1", 16, 32, 1, 1, "SAME", 1),
        ("g2_3x3", 32, 32, 3, 1, "SAME", 2),
        ("s3_3x3", 32, 48, 3, 3, "SAME", 1),
        ("s12_3x3", 48, 48, 3, (1, 2), "VALID", 1),
    ]
    for name, cin, cout, k, s, pad, groups in convs:
        x = b.conv2d(x, cin, cout, k, stride=s, padding=pad, groups=groups,
                     name=f"{name}_conv")
        x = b.relu(x, name=name)
    x = b.global_avgpool(x, name="gap")
    return b.build(b.dense(x, 48, classes, name="head"), family="cnn")


def conv_artifact(batch: int = 2, image: int = 32, seed: int = 0):
    """``conv_graph`` quantized as ``models.synthetic_quantized`` quantizes
    the zoo: random weights from ``init_params(seed)``, every activation
    scale ``SYNTHETIC_ACT_SCALE``, W4-PoT (first and last layer int8)."""
    from ..graph import GraphBuilder
    from ..graph.init_params import init_params
    from ..models import SYNTHETIC_ACT_SCALE
    from ..transform import QuantSpec, fold_batch_norm, quantize_graph

    g = conv_graph(GraphBuilder, batch=batch, image=image)
    fg, fp = fold_batch_norm(g, init_params(g, seed=seed))
    scales = dict.fromkeys(list(fg.inputs) + [n.name for n in fg.nodes], SYNTHETIC_ACT_SCALE)
    return quantize_graph(fg, fp, scales, QuantSpec(weight_bits=4, pot_candidates=5))


def tiny_vit_hd24(batch: int = 2, seed: int = 0):
    """A one-block ViT at W8 with heads 24 wide (image 64, patch 16, dim 48,
    2 heads, 10 classes)."""
    from ..models import synthetic_quantized

    return synthetic_quantized("vit_b16", seed=seed, batch=batch, image=64, classes=10,
                               dim=48, depth=1, heads=2, weight_bits=8)


# (k, cout) of the stems the stem kernel's plan takes no launch for
WIDE_STEMS = ((9, 64), (7, 288))


def stem_graph(builder, k: int, cout: int, batch: int = 2, image: int = 32,
               classes: int = 10):
    """A k x k stride-2 SAME stem on 3 channels to ``cout``, a pointwise
    conv, the classifier; built with ``builder``."""
    b = builder(f"stem_k{k}_co{cout}")
    x = b.input("image", (batch, image, image, 3))
    x = b.relu(b.conv2d(x, 3, cout, k, stride=2, padding="SAME", name="stem_conv"), name="stem")
    x = b.relu(b.conv2d(x, cout, 32, 1, name="pw_conv"), name="pw")
    x = b.global_avgpool(x, name="gap")
    return b.build(b.dense(x, 32, classes, name="head"), family="cnn")


def stem_artifact(k: int, cout: int, batch: int = 2, image: int = 32, seed: int = 0):
    """``stem_graph`` quantized as ``conv_artifact`` quantizes."""
    from ..graph import GraphBuilder
    from ..graph.init_params import init_params
    from ..models import SYNTHETIC_ACT_SCALE
    from ..transform import QuantSpec, fold_batch_norm, quantize_graph

    g = stem_graph(GraphBuilder, k, cout, batch=batch, image=image)
    fg, fp = fold_batch_norm(g, init_params(g, seed=seed))
    scales = dict.fromkeys(list(fg.inputs) + [n.name for n in fg.nodes], SYNTHETIC_ACT_SCALE)
    return quantize_graph(fg, fp, scales, QuantSpec(weight_bits=4, pot_candidates=5))
