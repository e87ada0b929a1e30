"""The least time of a forward (each artifact node's bound summed,
``counts.bound_s``) over its device busy time (``forward_ms``), in %."""
from .. import counts


def read(run):
    s = run.window.slice
    if s is None or run.peak is None:
        return None
    return counts.bound_s(run.graph, run.batch, run.peak) / (s.kernel_busy_s / s.calls) * 100.0
