"""Host time a call spends copying the batch into the Engine's input (the
host waits for the copy): the program's ``engine.copy_in`` span, the mean
over the window's calls outside the profiled slice."""
from .. import spans


def read(run):
    return spans.per_call_ms(run, spans.named_ns("engine.copy_in"))
