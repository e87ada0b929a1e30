"""The kernel sources nvcc compiled in the run's process: the program's
``kernels.compiled`` counter (0 where every library was already built)."""
from .. import spans


def read(run):
    return spans.counter("kernels.compiled")
