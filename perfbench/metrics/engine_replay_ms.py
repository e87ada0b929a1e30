"""Host time a call spends launching the captured forward: the program's
``engine.replay`` span, the mean over the window's calls outside the
profiled slice."""
from .. import spans


def read(run):
    return spans.per_call_ms(run, spans.named_ns("engine.replay"))
