"""Host time a call spends outside its steps (the input checks, the clone of
the logits): the program's ``engine.call`` span less its children's
(``engine.copy_in``, ``engine.replay``), the mean over the window's calls
outside the profiled slice."""
from .. import spans


def _self_ns(held):
    calls = {s.id: s for s in held if s.name == "engine.call"}
    if not calls:
        return None
    return (sum(s.end - s.start for s in calls.values())
            - sum(s.end - s.start for s in held if s.parent in calls))


def read(run):
    return spans.per_call_ms(run, _self_ns)
