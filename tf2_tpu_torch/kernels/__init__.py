"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their ctypes
wrappers and their plain PyTorch versions.

Each wrapper counts its launches; ``launch_counts`` reads the counts and
``reset_launch_counts`` sets them to 0, so a run can show which kernels
carried it. The GEMMs, the chain kernel and the stem kernel also count
the weights their wrappers had to prepare (into the kernel's layout) on a
call (``prepared_per_call``; the Engine prepares them at load, so its
forwards count none); the reset clears those too.
"""
from . import (detection, qattention, qblocks, qconv, qdwconv, qgelu, qlayernorm, qlrn,
               qstem, shift_matmul)

_COUNTS = (shift_matmul.LAUNCHES, qconv.LAUNCHES, qblocks.LAUNCHES, qlrn.LAUNCHES,
           qattention.LAUNCHES, qstem.LAUNCHES, detection.LAUNCHES, qlayernorm.LAUNCHES,
           qdwconv.LAUNCHES, qgelu.LAUNCHES)
_PREPARED = (shift_matmul.PREPARED_PER_CALL, qblocks.PREPARED_PER_CALL,
             qstem.PREPARED_PER_CALL)


def launch_counts() -> dict[str, int]:
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def prepared_per_call() -> dict[str, int]:
    return {k: v for counts in _PREPARED for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS + _PREPARED:
        for k in counts:
            counts[k] = 0
