"""The closed and the open loop, the metric readers' arithmetic and the
trace reader, on made-up calls and events."""
import math
import statistics
import time

import numpy as np
import pytest
import torch

from perfbench import harness, trace
from perfbench.metrics import (copy_in_ms, device_idle_share, engine_call_ms, forward_ms,
                               images_per_s, latency_p50_ms, latency_p95_ms, percentile,
                               step_mfu)
from perfbench.tests import tiny


def test_closed_loop_issues_until_the_deadline_in_order():
    batches = [torch.full((2, 3), float(i)) for i in range(5)]
    seen = []

    def call(x):
        seen.append(int(x[0, 0]))
        time.sleep(0.002)
        return x * 2

    w, prof = harness.drive(call, batches, 0.1)
    assert prof is None
    assert seen == [i % 5 for i in range(len(seen))] and len(seen) >= 10
    assert [c.batch for c in w.calls] == seen
    assert all(c.due == c.t0 <= c.t1 <= c.t2 for c in w.calls)
    assert all(a.t2 <= b.t0 for a, b in zip(w.calls, w.calls[1:]))   # closed: one in flight
    assert all(torch.equal(o, batches[c.batch] * 2) for o, c in zip(w.outputs, w.calls))
    assert w.calls[-2].t0 - w.calls[0].t0 < 0.1e9   # every call but the last issued in time


def test_gaps_are_one_set_in_an_order_drawn_from_the_seed():
    assert harness.arrival_gaps({"batch": 1}, 5) is None
    a, b = (harness.arrival_gaps({"rate_per_s": 250.0}, s) for s in (2**31 + 5, 2**33 + 7))
    assert len(a) == harness.N_GAPS and a != b and sorted(a) == sorted(b)
    assert a == harness.arrival_gaps({"rate_per_s": 250.0}, 2**31 + 5)
    assert statistics.fmean(a) == pytest.approx(1 / 250.0, rel=0.01)
    assert statistics.median(a) == pytest.approx(math.log(2) / 250.0, rel=0.01)


def test_open_loop_issues_each_request_when_it_falls_due():
    batches = [torch.full((1, 3), float(i)) for i in range(3)]
    gaps = [0.004, 0.001, 0.007]

    def call(x):
        time.sleep(0.0005)
        return x + 1

    w, _ = harness.drive(call, batches, 0.12, gaps)
    due = [c.due - w.calls[0].due for c in w.calls]
    want = [0]
    while len(want) < len(due):
        want.append(want[-1] + int(gaps[(len(want) - 1) % 3] * 1e9))
    assert due == want and due[-1] < 0.12e9 <= due[-1] + gaps[(len(due) - 1) % 3] * 1e9
    assert all(c.due <= c.t0 <= c.t1 <= c.t2 for c in w.calls)
    assert statistics.median(c.t0 - c.due for c in w.calls) < 1e6   # issued on time
    assert [c.batch for c in w.calls] == [i % 3 for i in range(len(w.calls))]


def test_open_loop_queues_behind_a_slow_call():
    """Over capacity a request waits for the last call to return, and its
    latency counts the wait from when it fell due."""
    batches = [torch.zeros(1, 2)]

    def call(x):
        time.sleep(0.005)
        return x

    w, _ = harness.drive(call, batches, 0.1, [0.001])
    assert len(w.calls) == 100
    assert all(b.t0 >= a.t2 for a, b in zip(w.calls, w.calls[1:]))
    waits = [c.t0 - c.due for c in w.calls]
    assert waits == sorted(waits) and waits[-1] > 0.3e9
    r = _run(w.calls, batch=1)
    assert latency_p95_ms.read(r) > 300 and r.window_s > 0.45


def test_percentile_is_numpys():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        v = rng.exponential(size=n).tolist()
        for p in (50, 95, 99):
            assert percentile(v, p) == pytest.approx(np.percentile(v, p), rel=1e-12)
    assert percentile(list(range(1, 6)), 50) == statistics.median(range(1, 6))


def _calls(times):
    """Closed-loop calls from (t0, t1, t2) in ns."""
    return [harness.Call(t0, t0, t1, t2, 0) for t0, t1, t2 in times]


def _run(calls, batch=4, sl=None, slice_first=0, slice_calls=0, slice_wall_s=0.0, peak=None,
         graph=None):
    w = harness.Window(calls=calls, outputs=[], slice=sl, slice_first=slice_first,
                       slice_calls=slice_calls, slice_wall_s=slice_wall_s)
    return harness.Run(tiny.cell("resnet50-w4pot.offline-b64"), batch, 1.0, w, graph, peak)


def test_end_to_end_readers():
    ms = 1_000_000
    calls = _calls((i * 10 * ms, i * 10 * ms + 2 * ms, i * 10 * ms + (3 + i) * ms)
                   for i in range(10))
    r = _run(calls)
    assert r.window_s == pytest.approx((90 + 12) / 1e3)
    assert images_per_s.read(r) == pytest.approx(40 / 0.102)
    lat = [3.0 + i for i in range(10)]
    assert latency_p50_ms.read(r) == pytest.approx(np.percentile(lat, 50))
    assert latency_p95_ms.read(r) == pytest.approx(np.percentile(lat, 95))
    assert engine_call_ms.read(r) == pytest.approx(2.0)
    open_loop = [c._replace(due=c.t0 - ms) for c in calls]   # each issued 1 ms late
    r = _run(open_loop)
    assert latency_p50_ms.read(r) == pytest.approx(np.percentile(lat, 50) + 1)
    assert r.window_s == pytest.approx((90 + 12 + 1) / 1e3)


def _ev(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_slice_and_its_readers():
    events = [
        _ev("user_annotation", "pb:call", 0, 100), _ev("user_annotation", "pb:to_host", 100, 50),
        _ev("user_annotation", "pb:call", 200, 100), _ev("user_annotation", "pb:to_host", 300, 100),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10, 20),
        _ev("kernel", "void tf2::qblockchain_kernel<qblockchain>(int)", 30, 40),
        _ev("kernel", "void at::native::elementwise_kernel<128>(int)", 60, 30),  # overlaps
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 120, 5),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 210, 20),
        _ev("kernel", "void tf2::qblockchain_kernel<qblockchain>(int)", 240, 50),
        _ev("kernel", "outside", 500, 10),
        _ev("cpu_op", "aten::copy_", 0, 10),
    ]
    s = trace.read(events)
    assert s.calls == 2 and s.window_s == pytest.approx(400e-6)
    assert s.kernel_busy_s == pytest.approx(110e-6)           # [30, 90] and [240, 290]
    assert s.device_busy_s == pytest.approx(155e-6)           # with the three copies
    assert s.h2d_s == pytest.approx(40e-6)
    fam = dict(s.device_ops)
    assert fam["qblockchain"] == pytest.approx(90e-6)
    assert fam["torch:elementwise_kernel"] == pytest.approx(30e-6)
    assert s.idle_gaps[0] == ["pb:loop", pytest.approx(150e-6)]       # 90 -> 240
    assert s.idle_gaps[1] == ["pb:to_host", pytest.approx(110e-6)]    # 290 -> 400
    graph = {"inputs": {"image": {"shape": [1, 2, 2, 3]}},
             "nodes": [{"name": "q", "op": "quantize", "inputs": ["image"], "params": [],
                        "attrs": {"scale": 0.02}}], "params": {}}
    peak = {"int8_ops_per_s": 1e12, "hbm_bytes_per_s": 1e6}
    us = 1000
    calls = _calls((i * 100 * us, i * 100 * us + 30 * us, (i + 1) * 100 * us) for i in range(12))
    r = _run(calls, batch=1, sl=s, slice_first=4, slice_calls=2, slice_wall_s=0.3e-3, peak=peak,
             graph=graph)
    assert forward_ms.read(r) == pytest.approx(0.055)
    assert copy_in_ms.read(r) == pytest.approx(0.02)
    # outside the slice: 10 calls in 0.9 ms of wall, 0.055 ms busy each
    assert device_idle_share.read(r) == pytest.approx((1 - 0.55 / 0.9) * 100)
    from perfbench.metrics import kernel_roofline_share
    assert kernel_roofline_share.read(r) == pytest.approx(12 * 5 / 1e6 / 55e-6 * 100)
    assert trace.read([e for e in events if e["cat"] != "kernel"]) is None
    assert trace.read([e for e in events if e["cat"] != "user_annotation"]) is None


def test_readers_leave_the_profiled_slice_out():
    ms = 1_000_000
    # the 20 profiled calls spend 1 ms in the Engine, the others 1 ns
    calls = _calls((i * ms, i * ms + (ms if 10 <= i < 30 else 1), (i + 1) * ms)
                   for i in range(100))
    graph = {"inputs": {"image": {"shape": [1, 8]}},
             "nodes": [{"name": "d", "op": "qdense", "inputs": ["image"], "params": [],
                        "attrs": {"kshape": [8, 4]}}], "params": {}}
    peak = {"int8_ops_per_s": 1e6, "hbm_bytes_per_s": 1e9}
    r = _run(calls, batch=2, slice_first=10, slice_calls=20, slice_wall_s=0.03, peak=peak,
             graph=graph)
    assert step_mfu.read(r) == pytest.approx(2 * 32 * 80 * 2 / 0.07 / 1e6 * 100)
    assert engine_call_ms.read(r) == pytest.approx(1e-6)   # the profiled calls left out
    assert step_mfu.read(_run(calls, graph=graph)) is None   # no peak for the card
