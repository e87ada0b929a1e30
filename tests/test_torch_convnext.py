"""ConvNeXt-T in the port (``models/convnext.py``): the float IR graph
against a plain PyTorch forward written from the paper's equations
(``tests/convnext_reference.py``), the published parameter count and
MACs, the layer-scale fold, the quantized artifact's nodes, its Engine on
the CPU against the benchmark's plain reference, and the coverage plan at
the published shapes. The reference package has no ConvNeXt, so nothing
here runs JAX."""
import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import convnext_reference
from perfbench import counts, families, reference
from tf2_tpu_torch.graph import execute, init_params
from tf2_tpu_torch.kernels import qblocks
from tf2_tpu_torch.models import get_model, synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.runtime.engine import Limits
from tf2_tpu_torch.transform import fold_batch_norm

SMALL = {"depths": (1, 1, 2, 1), "dims": (16, 32, 64, 128), "image": 32, "classes": 10}
CARD = Limits(256, qblocks.SMEM_LIMIT)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _small(batch=2):
    return get_model("convnext_t", batch=batch, **SMALL)


def _seeded(g, seed=0):
    """init_params, with biases, layer norm affines and layer scales
    random too, so that every term of every equation shows."""
    params = init_params(g, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k, v in params.items():
        if k.endswith((".b", ".offset")):
            params[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith((".scale", ".gamma")):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return params


def _close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_float_graph_equals_reference(seed):
    g = _small()
    params = _seeded(g, seed)
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal((2, 32, 32, 3)),
                        dtype=torch.float32)
    got = execute(g)({k: torch.as_tensor(v) for k, v in params.items()}, image=x)
    want = convnext_reference.forward({k: torch.as_tensor(v) for k, v in params.items()}, x,
                                      SMALL["depths"], SMALL["dims"], gelu="tanh")
    _close(got, want)


def test_layer_scale_folds_into_pw2():
    """fold_batch_norm folds each layer_scale into the conv before it (w
    and b times gamma over the output channels); the folded graph computes
    what the unfolded one did."""
    g = _small()
    params = _seeded(g, 3)
    fg, fp = fold_batch_norm(g, params)
    assert [n.op for n in g.nodes].count("layer_scale") == 5
    assert "layer_scale" not in {n.op for n in fg.nodes}
    assert not any(k.endswith(".gamma") for k in fp)
    np.testing.assert_array_equal(fp["s3b1_pw2.w"], params["s3b1_pw2.w"] * params["s3b1_ls.gamma"])
    np.testing.assert_array_equal(fp["s3b1_pw2.b"], params["s3b1_pw2.b"] * params["s3b1_ls.gamma"])
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 32, 32, 3)),
                        dtype=torch.float32)
    want = execute(g)({k: torch.as_tensor(v) for k, v in params.items()}, image=x)
    _close(execute(fg)({k: torch.as_tensor(v) for k, v in fp.items()}, image=x), want)


def test_published_size():
    """convnext_tiny: 28,589,128 parameters (torchvision's count, the
    layer scales included) and 4.46 GMAC an image at 224 x 224, here as
    perfbench.counts counts the artifact's graph."""
    g = get_model("convnext_t")
    assert g.name == "convnext_t"
    assert sum(int(np.prod(s.shape)) for s in g.params.values()) == 28_589_128
    cfg = json.loads((ROOT / "perfbench" / "configs" / "convnext-t-w4pot.json").read_text())
    graph, _ = families.build(cfg, None, "cpu")
    macs = counts.ops_per_image(graph) / 2
    assert macs == g.meta["flops_per_image"] / 2 == 4_455_531_264
    assert abs(macs / 4.47e9 - 1) < 0.01


@pytest.fixture(scope="module")
def tiny_art():
    return synthetic_quantized("convnext_t", batch=1, **SMALL)


def test_artifact_nodes(tiny_art):
    """Each block: a pot4 depthwise conv, a layer norm, two pot4 1x1 convs
    around a qgelu, a qadd; the stem and the classifier int8 dense layers,
    the downsamples pot4 ones; the pool between a dequantize and a
    quantize, then the head's qlayernorm."""
    kinds = collections.Counter(
        (n.op, n.attrs.get("wfmt"), n.attrs.get("groups", 1) > 1,
         tuple(n.attrs["kshape"][:2]) if n.op == "qconv2d" else None)
        for n in tiny_art.graph.nodes)
    assert kinds == {("qconv2d", "pot4", True, (7, 7)): 5, ("qconv2d", "pot4", False, (1, 1)): 10,
                     ("qlayernorm", None, False, None): 10, ("qgelu", None, False, None): 5,
                     ("qadd", None, False, None): 5, ("qdense", "pot4", False, None): 3,
                     ("qdense", "int8", False, None): 2, ("quantize", None, False, None): 2,
                     ("dequantize", None, False, None): 2,
                     ("global_avgpool", None, False, None): 1, ("reshape", None, False, None): 8,
                     ("transpose", None, False, None): 4}
    ops = [n.op for n in tiny_art.graph.nodes]
    i = ops.index("global_avgpool")
    assert ops[i - 1:i + 5] == ["dequantize", "global_avgpool", "quantize", "qlayernorm",
                                "qdense", "dequantize"]


@pytest.mark.parametrize("batch", [1, 3])
def test_engine_equals_benchmark_reference(tiny_art, batch):
    """The artifact's Engine on the CPU (its depthwise convs decoded to
    int8 at load, through the qdwconv wrapper's plain version) against the
    benchmark's plain reference, bit for bit."""
    g = tiny_art.graph.with_batch_size(batch)
    x = torch.as_tensor(np.random.default_rng(batch).standard_normal((batch, 32, 32, 3)),
                        dtype=torch.float32)
    eng = Engine(g, tiny_art.params, device="cpu")
    assert {n.attrs["wfmt"] for n in eng.graph.nodes if n.attrs.get("groups", 1) > 1} == {"int8"}
    got = eng.run(image=x)
    params = {k: torch.as_tensor(np.asarray(v)) for k, v in tiny_art.params.items()}
    want = reference.forward(json.loads(g.to_json()), params, x)
    assert torch.equal(got, want)
    assert (want.abs() < 127 * 0.02 - 1e-6).float().mean() > 0.5   # not saturated


def test_plan_leaves_nothing_plain_at_published_shapes():
    art = synthetic_quantized("convnext_t", batch=1)
    eng = Engine(art.graph, art.params, device="cpu")
    assert Engine.plan(eng.graph, eng.params, CARD) == frozenset()
    dws = [n for n in eng.graph.nodes if n.attrs.get("groups", 1) > 1]
    assert len(dws) == 18 and {n.attrs["wfmt"] for n in dws} == {"int8"}
