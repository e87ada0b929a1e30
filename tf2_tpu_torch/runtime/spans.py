"""The port's span recorder: what the program was doing, and when, on the
clock ``time.perf_counter_ns`` (the clock a caller stamps its own requests
with, so a reader selects spans by its requests' times with no conversion).

A span has a name, a start and an end (ns), its own id, the id of the span
that caused it (0: none) and the id of the Engine call it belongs to (0:
none; an ``engine.call`` span's is its own id). Two kinds:

- **call spans** (``begin``/``end``): an Engine call and its steps. They go
  to a ring of ``RING`` preallocated slots: recording one writes one slot,
  taken with ``next()`` on an ``itertools.count`` (atomic under the GIL, so
  two threads never write one slot), takes no lock and grows nothing. A
  record the ring overwrites is counted (``records().overwritten``).
- **set-up spans** (``span``, a context manager or a function's
  decorator): loading, planning, building, a few dozen a process. They go
  to a list, which a long-running process keeps whole; each nests under
  the set-up span open on its thread. Their ids are negative.

Counters (``count``) are plain integers beside the spans, over the whole
process:

| counter | where |
|---|---|
| ``kernels.compiled`` | ``kernels/build.build_all``: the sources nvcc compiled |
| ``engine.plain_nodes`` | ``Engine.plan``: the nodes it leaves to a plain version on the card, summed over the plans made |
| ``engine.dwconv_nodes`` | ``Engine.plan``: the depthwise convs it gives the ``qdwconv`` kernel, summed the same way |

The spans:

| span (parent) | where |
|---|---|
| ``kernels.build_all`` | ``kernels/build.build_all``: the sources' hash, nvcc where needed |
| ``kernels.open`` | ``kernels/build.library``: the ``ctypes.CDLL`` of one library, at its first use |
| ``artifact.load`` | ``transform/export.load_artifact``, hashes included |
| ``engine.init`` -> ``engine.routes``, ``engine.decode``, ``engine.pass.<rewrite>`` (each load pass that runs), ``engine.plan``, ``engine.stem_plan``, ``engine.weights`` | ``Engine.__init__`` |
| ``engine.build`` -> ``engine.build.warmup``, ``engine.build.capture`` | ``Engine.build`` |
| ``engine.call`` -> ``engine.copy_in``, ``engine.replay`` | ``Engine.__call__``: the copy into the Engine's inputs, then the forward (the captured graph's replay, or the eager forward where nothing is captured); the rest of the call (input checks, the outputs' clone) is its self time |

Always on: there is no switch. While ``torch.profiler`` runs
(``torch._C._autograd._profiler_enabled()``), each span is also entered as a
``torch.profiler.record_function`` range of its name, on the profiler's
timeline beside the device's copies and kernels; otherwise that costs one
flag check. ``mirror`` gives the same gated range to code that records no
span (the executor's per-node ranges)."""
from __future__ import annotations

import contextlib
import itertools
import threading
from time import perf_counter_ns
from typing import NamedTuple

import torch

RING = 1 << 18
COUNTERS = ("kernels.compiled", "engine.plain_nodes", "engine.dwconv_nodes")

_profiling = torch._C._autograd._profiler_enabled
_NO_RANGE = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start: int
    end: int
    id: int
    parent: int
    call: int


class Records(NamedTuple):
    setup: list[Span]      # in the order they ended
    calls: list[Span]      # the ring's, oldest first
    overwritten: int       # call spans the ring lost


def mirror(*parts: str):
    """A ``record_function`` range named ``":".join(parts)`` while the
    profiler runs; a no-op context otherwise."""
    return torch.profiler.record_function(":".join(parts)) if _profiling() else _NO_RANGE


class Recorder:
    def __init__(self, ring: int = RING):
        if ring & (ring - 1):
            raise ValueError(f"ring of {ring} slots: a power of two is needed")
        self._mask = ring - 1
        # the ring, one list a field (a call span's slot: its id & mask);
        # ints in preallocated lists, so recording makes no object the
        # garbage collector tracks
        self._names: list = [None] * ring
        self._starts: list = [0] * ring
        self._ends: list = [None] * ring      # None: never written, or open
        self._ids: list = [0] * ring
        self._parents: list = [0] * ring
        self._calls: list = [0] * ring
        self._ranges: list = [None] * ring    # the profiler's open ranges
        self._next = itertools.count(1)       # call span ids
        self._setup_ids = itertools.count(-1, -1)
        self._setup: list[Span] = []
        self._open = threading.local()        # the set-up spans open on each thread
        self._lock = threading.Lock()         # the counters'
        self._counters = dict.fromkeys(COUNTERS, 0)

    # ---- call spans ----

    def begin(self, name: str, parent: int = 0) -> int:
        """Start a call span caused by the call span ``parent`` (its id; 0:
        none, the span starts a call). -> its id, which ``end`` takes."""
        sid = next(self._next)
        i = sid & self._mask
        self._names[i] = name
        self._ends[i] = None
        self._ids[i] = sid
        self._parents[i] = parent
        self._calls[i] = self._calls[parent & self._mask] if parent else sid
        if _profiling():
            r = self._ranges[i] = torch.profiler.record_function(name)
            r.__enter__()
        self._starts[i] = perf_counter_ns()
        return sid

    def end(self, sid: int) -> None:
        t1 = perf_counter_ns()
        i = sid & self._mask
        r = self._ranges[i]
        if r is not None:
            self._ranges[i] = None
            r.__exit__(None, None, None)
        self._ends[i] = t1

    # ---- set-up spans and counters ----

    @contextlib.contextmanager
    def span(self, name: str):
        """A set-up span around the block, under the one open on this thread."""
        stack = self._open.__dict__.setdefault("stack", [])
        sid = next(self._setup_ids)
        parent = stack[-1] if stack else 0
        stack.append(sid)
        with mirror(name):
            t0 = perf_counter_ns()
            try:
                yield
            finally:
                t1 = perf_counter_ns()
                stack.pop()
                self._setup.append(Span(name, t0, t1, sid, parent, 0))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    # ---- reading ----

    def records(self) -> Records:
        ends = list(self._ends)
        calls = sorted(
            (Span(self._names[i], self._starts[i], e, self._ids[i], self._parents[i],
                  self._calls[i]) for i, e in enumerate(ends) if e is not None),
            key=lambda s: s.id)
        lost = max(self._ids) - len(ends)
        return Records(list(self._setup), calls, max(lost, 0))

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        self.__init__(len(self._ends))


_RECORDER = Recorder()
begin, end, span, count = _RECORDER.begin, _RECORDER.end, _RECORDER.span, _RECORDER.count
records, counters, reset = _RECORDER.records, _RECORDER.counters, _RECORDER.reset
