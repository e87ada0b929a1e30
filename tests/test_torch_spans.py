"""The span recorder (``tf2_tpu_torch/runtime/spans.py``): the ring's ids,
wrap and threads, the set-up list, the spans a small Engine records on the
CPU, the profiler mirror (gated, and nested in a CPU trace) and the
``kernels.compiled`` counter with nvcc stood in for."""
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tf2_tpu_torch.kernels import build
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine, spans
from tf2_tpu_torch.transform import load_artifact, save_artifact

INIT_STEPS = ["engine.routes", "engine.decode", "engine.pass.fuse_stem_quantize",
              "engine.pass.fuse_lrn_quantize", "engine.pass.hoist_input_quantize",
              "engine.pass.fuse_bottleneck_chains", "engine.plan", "engine.stem_plan",
              "engine.weights"]
CALL = ["engine.call", "engine.copy_in", "engine.replay"]


def test_ring_ids_parents_and_calls():
    r = spans.Recorder(8)
    a = r.begin("a")
    b = r.begin("b", a)
    c = r.begin("c", b)
    for sid in (c, b, a):
        r.end(sid)
    d = r.begin("d")
    r.end(d)
    rec = r.records()
    assert [(s.name, s.id, s.parent, s.call) for s in rec.calls] == [
        ("a", a, 0, a), ("b", b, a, a), ("c", c, b, a), ("d", d, 0, d)]
    assert rec.overwritten == 0 and rec.setup == []
    s = {x.name: x for x in rec.calls}
    assert s["a"].start <= s["b"].start <= s["c"].start <= s["c"].end <= s["b"].end <= s["a"].end


def test_ring_wraps_and_counts_what_it_lost():
    r = spans.Recorder(8)
    ids = []
    for _ in range(20):
        ids.append(r.begin("x"))
        r.end(ids[-1])
    rec = r.records()
    assert [s.id for s in rec.calls] == ids[-8:]
    assert rec.overwritten == 12
    open_id = r.begin("open")          # an open span is not read
    assert open_id not in [s.id for s in r.records().calls]
    with pytest.raises(ValueError):
        spans.Recorder(12)


def test_two_threads_record_at_once_and_no_record_is_torn():
    r = spans.Recorder(1 << 14)
    n = 2000

    def work(tag):
        for _ in range(n):
            c = r.begin(f"{tag}.call")
            s = r.begin(f"{tag}.step", c)
            r.end(s)
            r.end(c)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in "abcd"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    rec = r.records()
    assert len(rec.calls) == 4 * 2 * n and rec.overwritten == 0
    assert len({s.id for s in rec.calls}) == len(rec.calls)
    by_id = {s.id: s for s in rec.calls}
    for s in rec.calls:
        tag, kind = s.name.split(".")
        assert s.start <= s.end
        root = by_id[s.call]
        assert root.name == f"{tag}.call" and root.parent == 0
        if kind == "step":
            assert s.parent == s.call
            assert root.start <= s.start <= s.end <= root.end
        else:
            assert s.call == s.id


def test_setup_spans_nest_and_survive_a_wrap():
    r = spans.Recorder(8)
    with r.span("outer"):
        with r.span("inner"):
            pass
    with pytest.raises(RuntimeError):
        with r.span("failing"):
            raise RuntimeError("recorded all the same")
    for _ in range(100):
        r.end(r.begin("call"))
    rec = r.records()
    names = {s.name: s for s in rec.setup}
    assert [s.name for s in rec.setup] == ["inner", "outer", "failing"]
    assert names["inner"].parent == names["outer"].id and names["outer"].parent == 0
    assert names["failing"].parent == 0 and all(s.call == 0 for s in rec.setup)
    assert len({s.id for s in rec.setup} | {s.id for s in rec.calls}) == 3 + 8
    assert rec.overwritten == 92
    r.count("kernels.compiled", 3)
    assert r.counters() == {**dict.fromkeys(spans.COUNTERS, 0), "kernels.compiled": 3}
    r.reset()
    assert r.records() == ([], [], 0) and r.counters() == dict.fromkeys(spans.COUNTERS, 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    art = synthetic_quantized("resnet50", batch=1, image=32, depths=(1, 1, 1, 1), classes=10)
    path = tmp_path_factory.mktemp("art")
    save_artifact(str(path), art.graph, art.params)
    return str(path)


def _calls(rec):
    """The call spans grouped by call, each in the order it started."""
    out = {}
    for s in sorted(rec.calls, key=lambda s: s.start):
        out.setdefault(s.call, []).append(s)
    return list(out.values())


def _check_call(spans_of_call):
    call, *steps = spans_of_call
    assert [s.name for s in spans_of_call] == CALL
    assert call.parent == 0 and call.call == call.id
    assert all(s.parent == call.id and s.call == call.id for s in steps)
    assert call.start <= steps[0].start <= steps[0].end <= steps[1].start
    assert steps[1].end <= call.end


class _StandIn:
    """A CPU stand-in for the captured CUDA graph: its replay runs the
    eager forward on the static inputs into the static output."""

    def __init__(self, eng, static):
        self.eng, self.static = eng, static

    def replay(self):
        self.eng._static_out.copy_(self.eng._fn(self.eng.params, **self.static))


def test_engine_records_its_setup_and_each_call(artifact):
    spans.reset()
    graph, params = load_artifact(artifact)
    eng = Engine(graph, params, device="cpu")
    eng.build()
    rec = spans.records()
    by = {}
    for s in rec.setup:
        by.setdefault(s.name, []).append(s)
    assert {k: len(v) for k, v in by.items()} == dict.fromkeys(
        ["artifact.load", "engine.init", *INIT_STEPS, "engine.build", "engine.build.warmup"], 1)
    (init,) = by["engine.init"]
    (bld,) = by["engine.build"]
    steps = sorted((s for s in rec.setup if s.parent == init.id), key=lambda s: s.start)
    assert [s.name for s in steps] == INIT_STEPS
    assert all(init.start <= s.start <= s.end <= init.end for s in steps)
    assert by["engine.build.warmup"][0].parent == bld.id
    assert by["artifact.load"][0].parent == 0 and init.parent == 0
    assert rec.calls == []

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 32, 3),
                                                                  dtype=np.float32))
    want = eng(image=x)
    eng(image=x)
    # the replay path, with the CUDA graph stood in for
    eng._static_in = {"image": torch.zeros_like(x)}
    eng._static_out = torch.zeros_like(want)
    eng._graph = _StandIn(eng, eng._static_in)
    got = eng(image=x)
    assert torch.equal(got, want)
    calls = _calls(spans.records())
    assert len(calls) == 3
    for c in calls:
        _check_call(c)
    assert len(spans.records().setup) == len(rec.setup)   # calls add no set-up span


def test_no_range_without_a_profiler_and_nested_ranges_under_one(artifact, monkeypatch,
                                                                 tmp_path):
    graph, params = load_artifact(artifact)
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    eng = Engine(graph, params, device="cpu").build()
    x = torch.zeros(1, 32, 32, 3)
    eng(image=x)
    assert entered == []

    from torch.profiler import ProfilerActivity, profile

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng(image=x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert entered[:3] == CALL and len(entered) == 3 + len(eng.graph.nodes)
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    ranges = {}
    for e in ev:
        ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))

    def inside(inner, outer):
        return outer[0] <= inner[0] and inner[1] <= outer[1]

    (call,), (copy,), (fwd,) = (ranges[n] for n in CALL)
    assert inside(copy, call) and inside(fwd, call) and copy[1] <= fwd[0]
    nodes = [r for n in ranges if ":" in n for r in ranges[n]]
    assert len(nodes) == len(eng.graph.nodes) and all(inside(r, fwd) for r in nodes)
    (c,) = _calls(spans.records())
    _check_call(c)


class _Nvcc:
    """``subprocess.Popen`` of nvcc, stood in for: writes its output file."""

    def __init__(self, argv, **_):
        Path(argv[argv.index("-o") + 1]).write_bytes(b"")
        self.returncode = 0

    def communicate(self):
        return "", None


def test_build_all_counts_compiles_and_none_on_a_warm_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _Nvcc)
    before = spans.counters()["kernels.compiled"]
    n_spans = len(spans.records().setup)
    targets = build.build_all()
    assert all(p.exists() for p in targets.values())
    assert spans.counters()["kernels.compiled"] == before + len(build.SOURCES)
    build.build_all()
    assert spans.counters()["kernels.compiled"] == before + len(build.SOURCES)
    new = spans.records().setup[n_spans:]
    assert [s.name for s in new] == ["kernels.build_all"] * 2


def test_the_port_has_one_recorder():
    """Only ``runtime/spans.py`` enters profiler ranges in the port, and
    nothing in ``serve/`` or ``parallel/`` records a span."""
    root = Path(__file__).resolve().parents[1] / "tf2_tpu_torch"
    for f in root.rglob("*.py"):
        text = f.read_text()
        rel = f.relative_to(root).as_posix()
        if rel != "runtime/spans.py" and not rel.startswith("bench/"):
            assert "record_function" not in text, rel
        if rel.startswith(("serve/", "parallel/")):
            assert "spans." not in text, rel
