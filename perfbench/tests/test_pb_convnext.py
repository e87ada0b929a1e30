"""The ConvNeXt configuration at a tiny size of its own: the family's graph
is the one the port's Transform Kit makes from ``convnext_t``; a tiny cell
runs ``correct`` on the CPU; the control (4-bit activations) differs; the
depthwise metrics read the grouped nodes' bound over the kernel's time."""
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import artifact, counts, harness, manifest, reference
from perfbench.metrics import dwconv_ms, dwconv_roofline_share, plain_nodes
from perfbench.reference import files
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime.engine import Engine
from tf2_tpu_torch.transform.export import load_artifact

WORKLOAD = "convnext-t-w4pot.offline-b64"
SIZES = {"image_size": 32, "num_classes": 10, "depths": [1, 1, 2, 1], "dims": [16, 32, 64, 128]}


def _config():
    c = manifest.load(WORKLOAD)
    return dict(c.config, **SIZES, name="convnext-t-w4pot-tiny")


def _cell():
    c = manifest.load(WORKLOAD)
    return manifest.Cell(c.name, c.chips, _config(), dict(c.traffic, batch=4, compare_calls=3),
                         c.limits, c.end_to_end, c.per_layer)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    return artifact.make(_config(), 2**31 + 7, "cpu", tmp_path_factory.mktemp("art"))


def test_graph_is_the_transform_kits(made):
    g, _ = load_artifact(str(made))
    want = synthetic_quantized("convnext_t", batch=1, image=32, classes=10,
                               depths=(1, 1, 2, 1), dims=(16, 32, 64, 128)).graph
    assert [(n.name, n.op, n.inputs, n.params, n.attrs) for n in g.nodes] == \
        [(n.name, n.op, n.inputs, n.params, n.attrs) for n in want.nodes]
    assert g.inputs == want.inputs and g.outputs == want.outputs and g.params == want.params
    grouped = [n for n in g.nodes if n.attrs.get("groups", 1) > 1]
    assert [n.attrs["kshape"] for n in grouped] == [[7, 7, 1, 16], [7, 7, 1, 32],
                                                    [7, 7, 1, 64], [7, 7, 1, 64], [7, 7, 1, 128]]


def test_reference_equals_port_plain_path(made):
    g, p = load_artifact(str(made))
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    got = Engine(g.with_batch_size(3), p, device="cpu").run(image=x)
    rg, rp = files.load(made)
    want = reference.forward(rg, {k: torch.from_numpy(v) for k, v in rp.items()}, x)
    assert torch.equal(got, want)
    assert (want.abs() < 127 * 0.02 - 1e-6).float().mean() > 0.5   # not saturated


def test_control_differs(made):
    rg, rp = files.load(made)
    params = {k: torch.from_numpy(v) for k, v in rp.items()}
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    high = reference.forward(rg, params, x)
    low = reference.forward(rg, params, x, act_bits=4)
    assert ((high - low).abs() / 0.02).max() >= 5


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_correct(traced):
    t0 = time.perf_counter()
    out = harness.run(_cell(), 2**31 + 13, 0.5, traced, torch.device("cpu"),
                      lambda: time.perf_counter() - t0, warm_s=0.0)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0.0 for c in out["compared"].values())
    if not traced:
        assert set(out["metrics"]) == {"setup_s", "images_per_s"}


def _run(graph, batch, ops, calls=4):
    s = SimpleNamespace(device_ops=ops, calls=calls)
    return SimpleNamespace(window=SimpleNamespace(slice=s), graph=graph, batch=batch,
                           peak=counts.peaks("NVIDIA H100 80GB HBM3"))


def test_dwconv_metrics_read_the_grouped_nodes(made):
    graph = files.graph(made)
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    dws = [n for n in counts.nodes(graph, 64) if n["name"].endswith("_dw")]
    assert len(dws) == 5
    for n in dws:   # read and written once, the weights as 4-bit codes
        stage = int(n["name"][1])   # s<stage>b<i>_dw
        c, side = SIZES["dims"][stage - 1], 8 >> (stage - 1)
        assert n["bytes"] == 2 * 64 * side * side * c + 49 * c / 2
        assert n["macs"] == 64 * side * side * c * 49
    bound = sum(max(2 * n["macs"] / peak["int8_ops_per_s"], n["bytes"] / peak["hbm_bytes_per_s"])
                for n in dws)
    run = _run(graph, 64, [["qmatmul_pot4", 9e-3], ["torch:qdwconv_kernel", 2e-3]])
    assert dwconv_ms.read(run) == pytest.approx(0.5)
    assert dwconv_roofline_share.read(run) == pytest.approx(bound / 0.5e-3 * 100)
    assert dwconv_ms.read(_run(graph, 64, [["qmatmul_pot4", 9e-3]])) is None
    assert dwconv_roofline_share.read(_run(graph, 64, [["qmatmul_pot4", 9e-3]])) is None


def test_plain_nodes_reads_the_counter():
    from tf2_tpu_torch.runtime import spans

    assert plain_nodes.read(None) == spans.counters()["engine.plain_nodes"]
