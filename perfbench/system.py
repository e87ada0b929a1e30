"""The system under test, and the only module of the benchmark that imports
it: ``tf2_tpu_torch``'s kernel build, its artifact loader and its Engine,
with default options (``predecode``, ``block_fusion``, the committed
routes), built (one CUDA graph a forward)."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch


def build_kernels(cache_dir: Path) -> None:
    """Build (or find built) every kernel library in ``cache_dir``."""
    from tf2_tpu_torch.runtime import compile_cache

    compile_cache.enable(str(cache_dir))


def engine(artifact_dir: Path, batch: int, device: torch.device, example: torch.Tensor):
    """The artifact's Engine at ``batch``, built on ``example``; a call is
    ``engine(image=host_batch)``: the copy in, the replay and the clone of
    the logits."""
    from tf2_tpu_torch.runtime.engine import Engine
    from tf2_tpu_torch.transform.export import load_artifact

    t = time.perf_counter()
    graph, params = load_artifact(str(artifact_dir))
    t_load = time.perf_counter()
    eng = Engine(graph.with_batch_size(batch), params, device=device)
    t_engine = time.perf_counter()
    eng.build(image=example)
    print(f"perfbench: set-up load_artifact {t_load - t:.3f} s, Engine {t_engine - t_load:.3f} s, "
          f"build {time.perf_counter() - t_engine:.3f} s", file=sys.stderr)
    return eng
