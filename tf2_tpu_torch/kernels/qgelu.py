"""int8 GELU as one table lookup a code: int8 codes in, int8 out, in one pass.

An int8 input has 256 values, so dequantize -> tanh GELU -> quantize is a
256-entry table of output codes, indexed by code + 128. The table is built
once on the CPU (``kernels/dispatch._qgelu_table``) and copied to the
device; both versions read that one tensor, so no GELU arithmetic runs on
the card and every device gives the same bits.

``qgelu`` launches ``csrc/qgelu.cu`` on CUDA tensors (16-byte vectors, the
table in shared memory, any element count and alignment) and takes the plain
version (``qgelu_plain``, the gather) on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "qgelu.cu"
LAUNCHES = {"qgelu": 0}
# x, y, table, n, stream
_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library(SOURCE)
    lib.tf2_qgelu.argtypes, lib.tf2_qgelu.restype = _SIG, ctypes.c_int
    return lib


def qgelu_plain(x_q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel, on any device: the gather."""
    return table[x_q.to(torch.int64) + 128]


def qgelu(x_q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x_q int8 of any shape, table (256,) int8 -> int8 of x_q's shape.
    Raises on a CUDA tensor the kernel does not take (not contiguous, another
    dtype, or a table not 4-byte aligned)."""
    if x_q.device.type == "cpu":
        return qgelu_plain(x_q, table)
    build.check_operands(x_q.device, x_q=(x_q, torch.int8, tuple(x_q.shape)),
                         table=(table, torch.int8, (256,)))
    if table.data_ptr() % 4:
        raise ValueError("qgelu kernel: the table is not 4-byte aligned")
    y = torch.empty(x_q.shape, dtype=torch.int8, device=x_q.device)
    n = x_q.numel()
    if n == 0:
        return y
    rc = _lib().tf2_qgelu(x_q.data_ptr(), y.data_ptr(), table.data_ptr(), n,
                          build.raw_stream(x_q.device))
    build.check_launch(rc, "qgelu")
    LAUNCHES["qgelu"] += 1
    return y

