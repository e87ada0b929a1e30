"""The port's roofline count (``tf2_tpu_torch/bench/roofline.py``) against
the reference's ``bench/roofline.py`` on every zoo graph: the builders'
graphs at full size (``get_model`` in each package) and the synthetic
artifacts at small sizes (the port's ``synthetic_quantized``, its graph
read by the reference's IR). MACs, bytes, and the layer list (names, ops,
MACs, bytes) must be equal. The peaks differ (the reference's are a TPU's,
the port's the H100 data sheet's), so ``sol_*`` is checked against the
port's own peaks only."""
import json

import pytest

from bench.roofline import analyze as ref_analyze
from tf2_tpu.graph.ir import Graph as RefGraph
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu_torch.bench import roofline
from tf2_tpu_torch.models import get_model, synthetic_quantized
from tf2_tpu_torch.runtime import Engine

FULL = {"resnet50": dict(batch=64), "googlenet": dict(batch=64),
        "squeezenet_v1_1": dict(batch=64), "ssd": dict(batch=8, image=256),
        "vit_b16": dict(batch=64), "vit_b16_cls": dict(batch=8, image=384)}
SMALL = {"resnet50": dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64),
         "googlenet": dict(batch=2, image=64, classes=64),
         "squeezenet_v1_1": dict(batch=2, image=96, classes=64),
         "ssd": dict(batch=2, image=64),
         "vit_b16": dict(batch=2, image=64, classes=10, dim=64, depth=2, heads=4),
         "vit_b16_cls": dict(batch=2, image=64, classes=10, dim=64, depth=2, heads=4)}
W8 = ("vit_b16", "vit_b16_cls")


def _same_count(mine: dict, ref: dict):
    assert mine["total_gmacs"] == ref["total_gmacs"]
    assert mine["total_mbytes"] == ref["total_mbytes"]
    assert mine["bound"] in ("compute", "memory")
    assert len(mine["layers"]) == len(ref["layers"]) > 0
    assert mine["layers"] == ref["layers"]


@pytest.mark.parametrize("name", sorted(FULL))
def test_builder_graphs_count_as_reference(name):
    g, rg = get_model(name, **FULL[name]), ref_get_model(name, **FULL[name])
    _same_count(roofline.analyze(g), ref_analyze(rg))
    _same_count(roofline.analyze(g, int8=False), ref_analyze(rg, int8=False))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_synthetic_artifacts_count_as_reference(name):
    art = synthetic_quantized(name, seed=0, weight_bits=8 if name in W8 else 4, **SMALL[name])
    rg = RefGraph.from_json(art.graph.to_json())
    mine = roofline.analyze(art.graph)
    _same_count(mine, ref_analyze(rg))
    assert {layer["op"] for layer in mine["layers"]} <= {"qconv2d", "qdense", "attention"}


def test_sol_from_the_peaks(tmp_path):
    g = get_model("resnet50", batch=64)
    r = roofline.analyze(g)
    assert r["peaks"] == roofline.DATASHEET["source"]
    assert r["sol_compute_ms"] == pytest.approx(2 * r["total_gmacs"] * 1e9 / 1979e12 * 1e3)
    assert r["sol_memory_ms"] == pytest.approx(r["total_mbytes"] * 1e6 / 3.35e12 * 1e3)
    assert r["sol_ms"] == max(r["sol_compute_ms"], r["sol_memory_ms"])
    path = tmp_path / "peaks.json"
    path.write_text(json.dumps({"int8_tops": 1000.0, "bf16_tflops": 500.0,
                                "hbm_1r1w_gbps": 2000.0, "hbm_2r1w_gbps": 2500.0,
                                "card": "test card"}))
    peaks = roofline.load_peaks(str(path))
    m = roofline.analyze(g, peaks=peaks)
    assert m["total_gmacs"] == r["total_gmacs"] and "test card" in m["peaks"]
    assert m["sol_compute_ms"] == pytest.approx(2 * r["total_gmacs"] * 1e9 / 1000e12 * 1e3)
    assert m["sol_memory_ms"] == pytest.approx(r["total_mbytes"] * 1e6 / 2500e9 * 1e3)


def test_engine_graph_is_not_what_analyze_counts():
    """The block-fused Engine's graph hides its chains from the count (the
    reference counts no ``qblockchain`` node): give analyze the artifact's
    graph."""
    art = synthetic_quantized("resnet50", seed=0, **SMALL["resnet50"])
    eng = Engine(art.graph, art.params, device="cpu")
    assert any(n.op == "qblockchain" for n in eng.graph.nodes)
    assert roofline.analyze(eng.graph)["total_gmacs"] < roofline.analyze(art.graph)["total_gmacs"]
