"""The kernel build directory: the port's counterpart of the reference's
persistent XLA compilation cache (``tf2_tpu/runtime/compile_cache.py``).
Each kernel library is built once from the repository's sources
(``kernels/build.py``) and reused while its sources and flags are
unchanged."""
from __future__ import annotations

import os
from pathlib import Path

from ..kernels import build


def enable(cache_dir: str | None = None) -> str:
    """Build every kernel (``build.build_all``) into ``cache_dir``, or the
    directory ``TF2TPU_TORCH_KERNEL_CACHE`` names, or the git-ignored
    ``tf2_tpu_torch/kernels/build/``; returns its path. Call before the
    first launch: libraries already loaded stay loaded."""
    d = Path(cache_dir or os.environ.get(build.CACHE_ENV) or build.DEFAULT_BUILD_DIR)
    build.BUILD_DIR = d
    build.build_all()
    return str(d)
