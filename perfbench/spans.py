"""The program's own spans and counter, as the metric readers take them:
``tf2_tpu_torch.runtime.spans`` (its ``records()`` and ``counters()``), the
one module of the program this file imports. The spans are stamped with
``time.perf_counter_ns``, the clock of the harness's ``Call`` times, so they
are selected by the window's calls as they are. A revision of the program
without that recorder gives None, and the metrics that read it are left out
of the line."""
from __future__ import annotations

import bisect


def _recorder():
    try:
        from tf2_tpu_torch.runtime import spans
    except ImportError:
        return None
    return spans


def counter(name: str) -> int | None:
    """The program's counter ``name``, over the whole process."""
    rec = _recorder()
    return None if rec is None else rec.counters().get(name)


def setup_s(run, takes) -> float | None:
    """Seconds in the set-up spans whose name ``takes(name)`` accepts,
    summed over this run's set-up: spans that start after it began (the
    window's first call less ``setup_s``) and end before the window's first
    call. None where there is none."""
    rec = _recorder()
    if rec is None or not run.window.calls:
        return None
    t1 = run.window.calls[0].t0
    t0 = t1 - int(run.setup_s * 1e9)
    d = [s.end - s.start for s in rec.records().setup
         if takes(s.name) and t0 <= s.start and s.end <= t1]
    return sum(d) * 1e-9 if d else None


def per_call_ms(run, value) -> float | None:
    """The mean over the window's calls outside the profiled slice of
    ``value(spans)`` in ms, where ``spans`` are the call spans that start
    within one call's [t0, t1] and ``value`` gives ns, or None where the
    call has none of what it reads. None where no call has any."""
    rec = _recorder()
    calls = run.window.unprofiled()
    if rec is None or not calls:
        return None
    starts = [c.t0 for c in calls]
    held: dict[int, list] = {}
    for s in rec.records().calls:
        i = bisect.bisect_right(starts, s.start) - 1
        if i >= 0 and s.start <= calls[i].t1:
            held.setdefault(i, []).append(s)
    v = [x for x in map(value, held.values()) if x is not None]
    return sum(v) / len(v) * 1e-6 if v else None


def named_ns(name: str):
    """A ``value`` for ``per_call_ms``: the call's spans ``name``, summed."""
    def value(spans):
        d = [s.end - s.start for s in spans if s.name == name]
        return sum(d) if d else None
    return value
