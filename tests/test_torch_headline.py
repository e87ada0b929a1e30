"""The port's bench and entry: the headline bench's JSON line from given
measurements (``bench/headline.py: result_line``), ``entry()``'s
configuration, arguments and forward at the parity harness's small size
against the reference's ``__graft_entry__`` artifact recipe, and the kernel
build directory (``runtime/compile_cache.py``), on the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from tf2_tpu_torch.bench import headline
from tf2_tpu_torch.kernels import build
from tf2_tpu_torch.runtime import Engine, compile_cache

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_result_line_fields():
    line = headline.result_line([5000.0, 5300.0, 5200.0], [0.91, 0.88, 1.2],
                                "NVIDIA H100 80GB HBM3, 700.00 W",
                                {"block_fusion": [10000.0, 10600.0, 10400.0]})
    assert json.loads(json.dumps(line)) == line
    assert line["metric"] == headline.METRIC != "resnet50_int4shift_images_per_sec_per_chip"
    assert line["value"] == 5200.0 and line["unit"] == "img/s" and line["batch"] == 64
    assert line["p50_batch1_ms"] == 0.91
    assert line["samples_img_s"] == [5000.0, 5300.0, 5200.0]
    assert line["samples_batch1_ms"] == [0.91, 0.88, 1.2]
    assert line["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert "captured" in line["timing"] and "CUDA events" in line["timing"]
    assert line["block_fusion_img_s"] == 10400.0
    assert line["block_fusion_samples_img_s"] == [10000.0, 10600.0, 10400.0]
    assert "vs_baseline" not in line


def test_bench_options_are_not_defaults():
    """Each option the bench times on its own field is off in the default
    Engine (an option made the default would be timed as the value)."""
    import inspect

    params = inspect.signature(Engine.__init__).parameters
    for flags in headline.OPTIONS.values():
        for flag, on in flags.items():
            assert params[flag].default is not on


def test_entry_configuration_and_forward():
    """The reference's configuration (batch 8, 224x224); at the harness's
    small size the forward's logits equal the Engine's on the CPU."""
    from tf2_tpu_torch.entry import CONFIG, entry
    from tf2_tpu_torch.models import synthetic_quantized

    assert CONFIG == {"batch": 8, "image": 224}
    fwd, (params, image) = entry(device="cpu", **SMALL)
    assert tuple(image.shape) == (2, 64, 64, 3) and image.dtype == torch.float32
    y = fwd(params, image)
    assert tuple(y.shape) == (2, 64) and bool(torch.isfinite(y).all())
    art = synthetic_quantized("resnet50", seed=0, **SMALL)
    assert torch.equal(y, Engine(art.graph, art.params, device="cpu").run(image=image))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 64, 64, 3),
                                                                dtype=np.float32))
    assert torch.equal(fwd(params, x),
                       Engine(art.graph, art.params, device="cpu").run(image=x))


def test_entry_runs_on_the_card_by_default():
    from tf2_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the entry there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(**SMALL)


def test_compile_cache_builds_into_its_directory(monkeypatch, tmp_path):
    """``enable`` builds every kernel into the directory it is given, else
    the environment variable's, else the git-ignored default, and returns
    it; importing it builds nothing."""
    built = []
    monkeypatch.setattr(build, "build_all", lambda: built.append(build.BUILD_DIR))
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    assert compile_cache.enable(str(tmp_path / "a")) == str(tmp_path / "a")
    monkeypatch.setenv(build.CACHE_ENV, str(tmp_path / "b"))
    assert compile_cache.enable() == str(tmp_path / "b")
    monkeypatch.delenv(build.CACHE_ENV)
    assert compile_cache.enable() == str(build.DEFAULT_BUILD_DIR)
    assert built == [tmp_path / "a", tmp_path / "b", build.DEFAULT_BUILD_DIR]
    assert not (tmp_path / "a").exists()  # the build (stubbed here) makes it
    root = os.path.dirname(os.path.dirname(os.path.abspath(build.__file__)))
    with open(os.path.join(os.path.dirname(root), ".gitignore")) as f:
        assert "tf2_tpu_torch/kernels/build/" in f.read().split()
    assert build.DEFAULT_BUILD_DIR == build.CSRC.with_name("build")


def test_kernel_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the build runs there")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "k")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        compile_cache.enable(str(tmp_path / "k"))
    assert not any((tmp_path / "k").glob("*.so"))
