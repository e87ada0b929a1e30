"""One reader a metric: ``metrics/<name>.py`` has ``read(run) -> float |
None`` (``harness.Run``), found by the metric's name up to its first dot, so
``forward_ms.offline`` and ``forward_ms.stream`` share ``forward_ms.py``.
A reader that finds nothing to read returns None and the metric is left out
of the line."""
from __future__ import annotations


def percentile(values, p: float) -> float:
    """The p-th percentile with linear interpolation between the closest
    ranks (numpy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latencies_ms(run) -> list[float]:
    """Each request's time from when it fell due (in a closed loop: its
    issue) to its logits on the host."""
    return [(c.t2 - c.due) * 1e-6 for c in run.window.calls]
