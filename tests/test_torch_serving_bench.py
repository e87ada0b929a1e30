"""A CPU smoke of the port's serving bench at a tiny size:
``serving_bench.engine_steady``, ``serving_load`` and ``time_split`` on
``Engine(device="cpu")`` (seconds each; a CPU timing is no device number),
and its entry point and ``peaks`` raising without a card."""
import numpy as np
import pytest
import torch

from tf2_tpu_torch.bench import peaks, serving_bench
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def art():
    return synthetic_quantized("resnet50", seed=0, **SMALL)


@pytest.mark.parametrize("donate", [True, False])
def test_engine_steady_on_the_cpu(art, donate):
    r = serving_bench.engine_steady(art.graph, art.params, 2, 0.2, donate, device="cpu")
    assert r["steps"] >= 1 and r["img_per_s"] > 0
    assert r["donate"] is donate and r["device"] == "cpu"


def test_engine_steady_drives_a_given_engine(art):
    eng = Engine(art.graph, art.params, device="cpu", donate_inputs=True).build()
    r = serving_bench.engine_steady(art.graph, art.params, 2, 0.2, True, engine=eng)
    assert r["steps"] >= 1 and r["donate"] is True and r["device"] == "cpu"


def test_serving_load_on_the_cpu(art):
    r = serving_bench.serving_load(art.graph, art.params, 2, 0.3, clients=3, device="cpu")
    assert r["requests"] >= 1 and 0 < r["avg_occupancy"] <= 1
    assert r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
    assert r["captured"] is False and r["device"] == "cpu"


def test_time_split_on_the_cpu(art):
    eng = Engine(art.graph, art.params, device="cpu").build()
    examples = np.random.default_rng(0).standard_normal((3, 64, 64, 3)).astype(np.float32)
    r = serving_bench.time_split(eng, examples, steps=2)
    parts = ("assemble", "copy_in", "replay", "copy_out", "plumbing")
    assert all(r[f"{k}_ms"] >= 0 for k in parts)
    assert r["total_ms"] == pytest.approx(sum(r[f"{k}_ms"] for k in parts))
    assert r["input_mb"] == 2 * 64 * 64 * 3 * 4 / 1e6 and r["device"] == "cpu"


def test_card_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        peaks.measure()
    with pytest.raises(RuntimeError, match="CUDA"):
        serving_bench.main(["--synthetic"])
