"""Set-up seconds in the Engine's load passes: the program's
``engine.routes``, ``engine.decode`` and ``engine.pass.<rewrite>`` spans,
summed (children of ``engine.init``)."""
from .. import spans


def read(run):
    return spans.setup_s(run, lambda n: n in ("engine.routes", "engine.decode")
                         or n.startswith("engine.pass."))
