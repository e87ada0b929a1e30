"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their ctypes
wrappers and their plain PyTorch versions.

Each wrapper counts its launches; ``launch_counts`` reads the counts and
``reset_launch_counts`` sets them to 0, so a run can show which kernels
carried it.
"""
from . import qblocks, qconv, shift_matmul


def launch_counts() -> dict[str, int]:
    return {**shift_matmul.LAUNCHES, **qconv.LAUNCHES, **qblocks.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (shift_matmul.LAUNCHES, qconv.LAUNCHES, qblocks.LAUNCHES):
        for k in counts:
            counts[k] = 0
