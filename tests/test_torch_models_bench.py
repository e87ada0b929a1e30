"""A CPU smoke of the port's model bench (``tf2_tpu_torch/bench/
models_bench.py``): ``bench_row`` from a given time (no
``Engine.benchmark`` on the CPU) and ``ensure_artifact`` through the
port's CLI with ``--platform cpu``: made, reused, made again when stale,
under a path that holds the port's name."""
import tempfile

import numpy as np
import pytest
import torch

from tf2_tpu_torch.bench import models_bench, roofline
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import load_artifact


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_bench_row():
    art = synthetic_quantized("squeezenet_v1_1", seed=0, batch=2, image=64, classes=10)
    row = models_bench.bench_row("squeezenet_v1_1", 2, 4, 64, 0.0, 0.004, art.graph, True,
                                 "a card")
    sol = roofline.analyze(art.graph)["sol_ms"]
    assert row["img_per_s"] == 500.0 and row["ms_per_batch"] == 4.0
    assert row["sol_ms"] == round(sol, 4) and row["sol_fraction"] == round(sol / 4.0, 4)
    assert row["captured"] is True and row["card"] == "a card"
    assert set(row) >= {"model", "batch", "wbits", "image", "prune", "bound", "peaks"}


def test_ensure_artifact_makes_reuses_and_remakes(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = models_bench.artifact_dir("squeezenet_v1_1", 8, 64)
    assert out.parent == tmp_path and "tf2_tpu_torch" in out.name
    got = models_bench.ensure_artifact("squeezenet_v1_1", 8, 64, platform="cpu")
    assert got == out and (out / "graph.json").exists()
    stamps = list(out.glob(".stamp_*"))
    assert len(stamps) == 1
    mtime = (out / "graph.json").stat().st_mtime_ns
    models_bench.ensure_artifact("squeezenet_v1_1", 8, 64, platform="cpu")
    assert (out / "graph.json").stat().st_mtime_ns == mtime  # reused
    stamps[0].unlink()  # an artifact whose sources are not known: stale
    (out / "marker").write_text("")
    models_bench.ensure_artifact("squeezenet_v1_1", 8, 64, platform="cpu")
    assert not (out / "marker").exists() and len(list(out.glob(".stamp_*"))) == 1
    graph, params = load_artifact(str(out))
    y = Engine(graph, params, device="cpu").run(
        image=np.zeros(tuple(graph.inputs["image"].shape), np.float32))
    assert tuple(y.shape) == (2, 1000) and bool(torch.isfinite(y).all())
