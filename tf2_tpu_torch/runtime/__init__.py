"""The Engine (``engine.py``), imported at first use: the kernels, the
executor and the artifact loader import ``spans`` from this package, and
the Engine imports them."""


def __getattr__(name: str):
    if name == "Engine":
        from .engine import Engine
        return Engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
