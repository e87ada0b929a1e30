"""Model zoo of the port: IR graph builders by name. Every model of
``tf2_tpu.models``: the CNNs (ResNet-50, GoogLeNet, SqueezeNet v1.1), the
SSD detector (``ssd``) and ViT-B/16 (``vit_b16``, and ``vit_b16_cls`` with a
class token); and one the reference does not have, ConvNeXt-T
(``convnext_t``), held against plain PyTorch references instead."""
from __future__ import annotations

from ..graph.ir import Graph
from . import convnext, googlenet, resnet, squeezenet, ssd, vit

_REGISTRY = {"resnet50": resnet.build, "googlenet": googlenet.build,
             "squeezenet_v1_1": squeezenet.build, "ssd": ssd.build, "vit_b16": vit.build,
             "vit_b16_cls": lambda **kw: vit.build(cls_token=True, **kw),
             "convnext_t": convnext.build}


def get_model(name: str, **kwargs) -> Graph:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    return sorted(_REGISTRY)


SYNTHETIC_ACT_SCALE = 0.02


def synthetic_quantized(name: str, seed: int = 0, weight_bits: int = 4, **kwargs):
    """An artifact without a calibration forward: random weights from
    ``init_params(seed)``, BN folded, the stride == kernel convs patchified
    (``graph.optimize.patchify_stem``: the ViT patch embedding, ConvNeXt's
    stem and downsamples; the other CNNs have none), ConvNeXt's layer
    scales folded, every activation scale set to ``SYNTHETIC_ACT_SCALE``,
    weights at ``weight_bits`` (4: PoT codes, 8: int8; first and last layer
    int8 either way); SSD's priors from ``ssd.init_priors``. The compute
    graph is the one a calibrated artifact has."""
    from ..graph.init_params import init_params
    from ..graph.optimize import patchify_stem
    from ..transform import QuantSpec, fold_batch_norm, quantize_graph

    g = get_model(name, **kwargs)
    params = init_params(g, seed=seed)
    if name == "ssd":
        params.update(ssd.init_priors(g))
    fg, fp = patchify_stem(*fold_batch_norm(g, params))
    scales = dict.fromkeys(fg.inputs, SYNTHETIC_ACT_SCALE)
    scales.update(dict.fromkeys((n.name for n in fg.nodes), SYNTHETIC_ACT_SCALE))
    return quantize_graph(fg, fp, scales,
                          QuantSpec(weight_bits=weight_bits, pot_candidates=5))
