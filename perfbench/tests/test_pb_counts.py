"""The counts behind ``step_mfu`` and ``kernel_roofline_share``: conv and
dense nodes as the port's ``bench/roofline.analyze`` counts them, on the
same artifact graph; the other nodes by their bytes."""
import json

import pytest

from perfbench import artifact, counts
from perfbench.tests import tiny
from tf2_tpu_torch.bench.roofline import DATASHEET, analyze
from tf2_tpu_torch.transform.export import load_artifact


@pytest.fixture(scope="module", params=["resnet50-w4pot", "vit-b16-w8"])
def art(request, tmp_path_factory):
    return artifact.make(tiny.config(request.param), 9, "cpu", tmp_path_factory.mktemp("c"))


@pytest.mark.parametrize("batch", [1, 64])
def test_conv_and_dense_equal_analyze(art, batch):
    g, _ = load_artifact(str(art))
    want = {x["name"]: (x["macs"], x["bytes"]) for x in analyze(g.with_batch_size(batch))["layers"]}
    graph = json.loads((art / "graph.json").read_text())
    got = {n["name"]: (n["macs"], n["bytes"]) for n in counts.nodes(graph, batch)
           if n["op"] in ("qconv2d", "qdense")}
    assert got == want


def test_other_nodes(art):
    graph = json.loads((art / "graph.json").read_text())
    by = {n["name"]: n for n in counts.nodes(graph, 2)}
    q = by["image__q"] if "image__q" in by else by["patch_embed__p2__q"]
    assert q["bytes"] == 2 * 32 * 32 * 3 * 5                  # f32 in, int8 out
    for n in by.values():
        if n["op"] == "reshape":
            assert n["bytes"] == 0
        if n["op"] == "qadd":
            assert n["macs"] == 0 and n["bytes"] > 0
    att = [n for n in by.values() if n["op"] == "qattention_core"]
    for n in att:
        assert n["macs"] == 2 * 2 * 4 * 4 * 64                # 2 B T^2 D, T = 4 patches


def test_bound_and_ops(art):
    graph = json.loads((art / "graph.json").read_text())
    nodes = counts.nodes(graph, 1)
    assert counts.ops_per_image(graph) == 2 * sum(n["macs"] for n in nodes)
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert peak["int8_ops_per_s"] == DATASHEET["int8_ops_per_s"]
    assert peak["hbm_bytes_per_s"] == DATASHEET["hbm_bytes_per_s"]
    b = counts.bound_s(graph, 64, peak)
    assert b >= max(2 * sum(n["macs"] for n in counts.nodes(graph, 64)) / peak["int8_ops_per_s"],
                    sum(n["bytes"] for n in counts.nodes(graph, 64)) / peak["hbm_bytes_per_s"])
    assert counts.peaks("some other card") is None


def test_full_size_counts():
    """At the published sizes (the graph alone, no weights drawn): ResNet-50
    4.09 GMAC an image, ViT-B/16 16.76 in its dense layers and 0.71 in its
    attention products."""
    import torch

    from perfbench import families, manifest

    for w, gmac, att in (("resnet50-w4pot.offline-b64", 4.09, 0.0),
                         ("vit-b16-w8.offline-b64", 16.76, 0.708)):
        graph, params = families.build(manifest.load(w).config, None, torch.device("meta"))
        assert params == {}
        nodes = counts.nodes(graph, 1)
        dense = sum(n["macs"] for n in nodes if n["op"] != "qattention_core")
        assert abs(dense / 1e9 - gmac) < 0.01
        assert abs(sum(n["macs"] for n in nodes) / 1e9 - gmac - att) < 0.01
