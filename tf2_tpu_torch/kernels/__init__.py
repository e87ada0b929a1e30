"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their ctypes
wrappers and their plain PyTorch versions.

Each wrapper counts its launches; ``launch_counts`` reads the counts and
``reset_launch_counts`` sets them to 0, so a run can show which kernels
carried it.
"""
from . import qattention, qblocks, qconv, qlrn, qstem, shift_matmul

_COUNTS = (shift_matmul.LAUNCHES, qconv.LAUNCHES, qblocks.LAUNCHES, qlrn.LAUNCHES,
           qattention.LAUNCHES, qstem.LAUNCHES)


def launch_counts() -> dict[str, int]:
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0
