"""Set-up seconds in the Engine's coverage and stem plans: the program's
``engine.plan`` and ``engine.stem_plan`` spans, summed (children of
``engine.init``)."""
from .. import spans


def read(run):
    return spans.setup_s(run, lambda n: n in ("engine.plan", "engine.stem_plan"))
