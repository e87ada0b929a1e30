"""The benchmark's artifact and its frozen reference against the port: the
graph the benchmark writes is the one the port's own synthetic artifact has,
node for node; the reference's logits equal the port's plain path on it;
the control (4-bit activations) does not."""
import pytest
import torch

from perfbench import artifact, reference
from perfbench.reference import files
from perfbench.tests import tiny
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime.engine import Engine
from tf2_tpu_torch.transform.export import load_artifact

PORT = {"resnet50-w4pot": lambda: synthetic_quantized(
            "resnet50", batch=1, image=32, classes=10, depths=(1, 1, 1, 1)),
        "vit-b16-w8": lambda: synthetic_quantized(
            "vit_b16", batch=1, image=32, classes=10, dim=64, depth=1, heads=4, weight_bits=8)}


@pytest.fixture(scope="module", params=sorted(PORT))
def made(request, tmp_path_factory):
    cfg = tiny.config(request.param)
    return request.param, artifact.make(cfg, 2**31 + 5, "cpu", tmp_path_factory.mktemp("art"))


def test_graph_is_the_ports(made):
    name, d = made
    g, _ = load_artifact(str(d))
    want = PORT[name]().graph
    assert [(n.name, n.op, n.inputs, n.params, n.attrs) for n in g.nodes] == \
        [(n.name, n.op, n.inputs, n.params, n.attrs) for n in want.nodes]
    assert g.inputs == want.inputs and g.outputs == want.outputs
    assert {k: v for k, v in g.params.items()} == {k: v for k, v in want.params.items()}


@pytest.mark.parametrize("batch", [1, 3])
def test_reference_equals_port_plain_path(made, batch):
    _, d = made
    g, p = load_artifact(str(d))
    x = torch.randn(batch, 32, 32, 3, generator=torch.Generator().manual_seed(batch))
    got = Engine(g.with_batch_size(batch), p, device="cpu").run(image=x)
    rg, rp = files.load(d)
    want = reference.forward(rg, {k: torch.from_numpy(v) for k, v in rp.items()}, x)
    assert torch.equal(got, want)
    assert (want.abs() < 127 * 0.02 - 1e-6).float().mean() > 0.5   # not saturated


def test_control_differs(made):
    _, d = made
    rg, rp = files.load(d)
    params = {k: torch.from_numpy(v) for k, v in rp.items()}
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    high = reference.forward(rg, params, x)
    low = reference.forward(rg, params, x, act_bits=4)
    assert ((high - low).abs() / 0.02).max() >= 5


def test_artifact_is_kept_per_seed(tmp_path):
    cfg = tiny.config("resnet50-w4pot")
    a = artifact.make(cfg, 3, "cpu", tmp_path)
    stamp = (a / "weights.safetensors").stat().st_mtime_ns
    assert artifact.make(cfg, 3, "cpu", tmp_path) == a
    assert (a / "weights.safetensors").stat().st_mtime_ns == stamp
    b = artifact.make(cfg, 4, "cpu", tmp_path)
    assert files.read_safetensors(a / "weights.safetensors").keys() == \
        files.read_safetensors(b / "weights.safetensors").keys()
    wa = files.read_safetensors(a / "weights.safetensors")["s1b0_c3.wp"]
    wb = files.read_safetensors(b / "weights.safetensors")["s1b0_c3.wp"]
    assert (wa != wb).any()
