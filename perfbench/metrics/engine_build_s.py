"""Set-up seconds in ``Engine.build``: the program's ``engine.build`` span
(its eager warm-up forward and the capture of the CUDA graph)."""
from .. import spans


def read(run):
    return spans.setup_s(run, lambda n: n == "engine.build")
