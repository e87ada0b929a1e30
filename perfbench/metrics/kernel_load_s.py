"""Set-up seconds in the kernel libraries: the program's ``kernels.build_all``
spans (the sources' hash, nvcc where a library is missing) and
``kernels.open`` spans (the ``ctypes.CDLL`` of each library at its first
use; these also count in the span that holds them, ``engine.init`` or
``engine.build``), summed."""
from .. import spans


def read(run):
    return spans.setup_s(run, lambda n: n in ("kernels.build_all", "kernels.open"))
