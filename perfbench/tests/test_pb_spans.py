"""The readers of the program's spans (``perfbench/spans.py``): each on a
hand-made run and recorder state, none where the program has no recorder,
and a tiny traced CPU run that carries every one of them."""
import sys

import pytest

from perfbench import harness, spans, system
from perfbench.metrics import (artifact_load_s, engine_build_s, engine_call_ms,
                               engine_copy_in_ms, engine_passes_s, engine_plans_s,
                               engine_replay_ms, engine_self_ms, engine_weights_s,
                               kernel_compiles, kernel_load_s)
from perfbench.tests import tiny
from tf2_tpu_torch.runtime.spans import Records, Span

SETUP = {"kernel_load_s": kernel_load_s, "artifact_load_s": artifact_load_s,
         "engine_passes_s": engine_passes_s, "engine_plans_s": engine_plans_s,
         "engine_weights_s": engine_weights_s, "engine_build_s": engine_build_s}
CALL = {"engine_copy_in_ms": engine_copy_in_ms, "engine_replay_ms": engine_replay_ms,
        "engine_self_ms": engine_self_ms}
MS = 1_000_000


class _Recorder:
    def __init__(self, setup=(), calls=(), counters=None):
        self._r = Records(list(setup), list(calls), 0)
        self._c = counters or {"kernels.compiled": 0}

    def records(self):
        return self._r

    def counters(self):
        return dict(self._c)


def _run(calls, setup_s=1.0, slice_first=0, slice_calls=0):
    w = harness.Window(calls=calls, slice_first=slice_first, slice_calls=slice_calls)
    return harness.Run(tiny.cell("resnet50-w4pot.stream-b1"), 1, setup_s, w, {}, None)


def _call_spans(sid, t0, copy, replay, self_ns):
    """One Engine call's spans from ``t0``: the copy, then the replay, with
    ``self_ns`` around them."""
    a = t0 + self_ns // 2
    b = a + copy
    return [Span("engine.call", t0, b + replay + self_ns - self_ns // 2, sid, 0, sid),
            Span("engine.copy_in", a, b, sid + 1, sid, sid),
            Span("engine.replay", b, b + replay, sid + 2, sid, sid)]


def test_setup_readers_sum_their_spans_of_this_runs_setup(monkeypatch):
    s0 = 10 * 1000 * MS      # the run's set-up starts at 10 s, its window at 12 s
    names = [("kernels.build_all", 5), ("kernels.open", 7), ("artifact.load", 30),
             ("engine.init", 900), ("engine.routes", 100), ("engine.decode", 200),
             ("engine.pass.fuse_bottleneck_chains", 300), ("engine.pass.shard_tp", 1),
             ("engine.plan", 40), ("engine.stem_plan", 2), ("engine.weights", 60),
             ("engine.build", 500), ("engine.build.warmup", 400), ("kernels.open", 11)]
    setup = [Span(n, s0 + i * MS, s0 + i * MS + d * MS, -i - 1, 0, 0)
             for i, (n, d) in enumerate(names)]
    # an earlier run's, and one that ends inside the window: not this set-up's
    setup += [Span("engine.weights", s0 - 5000 * MS, s0 - 4000 * MS, -99, 0, 0),
              Span("engine.build", s0 + 1900 * MS, s0 + 2100 * MS, -98, 0, 0)]
    rec = _Recorder(setup, counters={"kernels.compiled": 3})
    monkeypatch.setattr(spans, "_recorder", lambda: rec)
    r = _run([harness.Call(s0 + 2000 * MS, s0 + 2000 * MS, s0 + 2001 * MS,
                           s0 + 2002 * MS, 0)], setup_s=2.0)
    got = {k: m.read(r) for k, m in SETUP.items()}
    assert got == pytest.approx({"kernel_load_s": 0.023, "artifact_load_s": 0.030,
                                 "engine_passes_s": 0.601, "engine_plans_s": 0.042,
                                 "engine_weights_s": 0.060, "engine_build_s": 0.500})
    assert kernel_compiles.read(r) == 3
    monkeypatch.setattr(spans, "_recorder", lambda: _Recorder())
    assert all(m.read(r) is None for m in SETUP.values())
    assert kernel_compiles.read(r) == 0


def test_call_readers_take_the_mean_over_the_unprofiled_calls(monkeypatch):
    calls, recs = [], []
    for i in range(10):
        t0 = i * 10 * MS
        calls.append(harness.Call(t0, t0, t0 + 2 * MS, t0 + 3 * MS, 0))
        # calls 4-5 are profiled and slower; call 7 recorded nothing
        k = 5 if i in (4, 5) else 1
        if i != 7:
            recs += _call_spans(100 * i + 1, t0 + 1000, 300_000 * k, 20_000 * k, 50_000 * k)
    recs.append(Span("engine.call", 200 * MS, 201 * MS, 5000, 0, 5000))   # outside the window
    monkeypatch.setattr(spans, "_recorder", lambda: _Recorder(calls=recs))
    r = _run(calls, slice_first=4, slice_calls=2)
    assert engine_copy_in_ms.read(r) == pytest.approx(0.3)
    assert engine_replay_ms.read(r) == pytest.approx(0.02)
    assert engine_self_ms.read(r) == pytest.approx(0.05)
    r = _run(calls)
    assert engine_copy_in_ms.read(r) == pytest.approx((0.3 * 7 + 1.5 * 2) / 9)
    monkeypatch.setattr(spans, "_recorder", lambda: _Recorder())
    assert all(m.read(r) is None for m in CALL.values())


def test_without_the_programs_recorder_every_reader_gives_none(monkeypatch):
    """An older revision of the program, which has no ``runtime/spans.py``."""
    import tf2_tpu_torch.runtime as rt

    monkeypatch.delattr(rt, "spans")
    monkeypatch.setitem(sys.modules, "tf2_tpu_torch.runtime.spans", None)
    assert spans._recorder() is None
    r = _run([harness.Call(0, 0, MS, 2 * MS, 0)])
    for m in [*SETUP.values(), *CALL.values(), kernel_compiles]:
        assert m.read(r) is None


@pytest.mark.parametrize("workload", ["resnet50-w4pot.stream-b1", "resnet50-w4pot.offline-b64"])
def test_tiny_traced_run_carries_every_span_metric(workload, monkeypatch, tmp_path):
    """The kernel build stood in for (every library already built, nvcc
    never called), as the harness builds the kernels on the card."""
    from tf2_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("nvcc called on a warm directory"))
    for src in build.SOURCES:
        build._target(src).touch()
    real = system.engine

    def engine(*args, **kwargs):
        system.build_kernels(tmp_path)
        return real(*args, **kwargs)

    monkeypatch.setattr(system, "engine", engine)
    runs = []

    class Capturing(harness.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Capturing)
    compiled = spans.counter("kernels.compiled")   # the process's, before the run
    out = tiny.run(workload, traced=True, seconds=0.3)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    kind = workload.rsplit("-", 1)[0].split(".")[1]
    want = {f"{k}.setup" for k in SETUP} | {"kernel_compiles.setup"}
    want |= ({f"{k}.stream" for k in CALL} if kind == "stream" else {"engine_copy_in_ms.offline"})
    assert want <= set(m) and all(m[k] is not None for k in want)
    assert m["kernel_compiles.setup"] == compiled   # nothing compiled in the run
    (run,) = runs
    assert sum(m[f"{k}.setup"] for k in SETUP) <= run.setup_s
    assert all(m[f"{k}.setup"] > 0 for k in SETUP)
    if kind == "stream":
        steps = sum(m[f"{k}.stream"] for k in CALL)
        assert 0 < steps <= engine_call_ms.read(run)
