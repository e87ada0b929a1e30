"""Model zoo of the port: IR graph builders by name. This slice has
ResNet-50; the other families of ``tf2_tpu.models`` come with later
slices."""
from __future__ import annotations

from ..graph.ir import Graph
from . import resnet

_REGISTRY = {"resnet50": resnet.build}


def get_model(name: str, **kwargs) -> Graph:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    return sorted(_REGISTRY)


SYNTHETIC_ACT_SCALE = 0.02


def synthetic_quantized(name: str, seed: int = 0, **kwargs):
    """A W4-PoT artifact without a calibration forward: random weights from
    ``init_params(seed)``, BN folded, every activation scale set to
    ``SYNTHETIC_ACT_SCALE``. The compute graph is the one a calibrated
    artifact has."""
    from ..graph.init_params import init_params
    from ..transform import QuantSpec, fold_batch_norm, quantize_graph

    g = get_model(name, **kwargs)
    fg, fp = fold_batch_norm(g, init_params(g, seed=seed))
    scales = dict.fromkeys(fg.inputs, SYNTHETIC_ACT_SCALE)
    scales.update(dict.fromkeys((n.name for n in fg.nodes), SYNTHETIC_ACT_SCALE))
    return quantize_graph(fg, fp, scales, QuantSpec(weight_bits=4, pot_candidates=5))
