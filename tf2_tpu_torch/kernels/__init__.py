"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their ctypes
wrappers and their plain PyTorch versions.

``MODULES`` lists the kernel modules, one line each; each declares its
source under ``csrc/`` (``SOURCE``: what ``build.build_all`` compiles) and
counts its launches (``LAUNCHES``: ``launch_counts``), and the GEMMs, the
chain kernel and the stem kernel the weights their wrappers prepared on a call
(``PREPARED_PER_CALL``: ``prepared_per_call``; none on an Engine's
forward). ``reset_launch_counts`` sets both to 0. Which kernel runs a node
is decided in ``dispatch.kernel_of``.
"""
from . import (build, detection, qattention, qblocks, qconv, qdwconv, qgelu, qlayernorm, qlrn,
               qstem, shift_matmul)

MODULES = (
    shift_matmul,
    qconv,
    qblocks,
    qlrn,
    qattention,
    qstem,
    detection,
    qlayernorm,
    qdwconv,
    qgelu,
)
_COUNTS = tuple(m.LAUNCHES for m in MODULES)
_PREPARED = tuple(m.PREPARED_PER_CALL for m in MODULES if hasattr(m, "PREPARED_PER_CALL"))


def launch_counts() -> dict[str, int]:
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def prepared_per_call() -> dict[str, int]:
    return {k: v for counts in _PREPARED for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS + _PREPARED:
        for k in counts:
            counts[k] = 0
