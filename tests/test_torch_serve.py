"""The port's serving layer (``tf2_tpu_torch/serve/``) on the CPU: the
reference's batcher cases and its HTTP end-to-end test
(tests/dist/test_serve.py) on the port's Engine, a thread stress of the
batcher, and a served ResNet-50 (``synthetic_quantized`` at the parity
harness's size: batch 2, image 64, depths (1,1,1,1)) whose every response
equals bit for bit its row of a direct ``Engine.run``, through threads and
HTTP, and whose logits meet the zoo tests' bar against the reference's
InferenceServer on JAX CPU. Every wait is bounded and every HTTP server
binds port 0."""
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tf2_tpu.graph.ir import Graph as RefGraph
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.serve import InferenceServer as RefInferenceServer
from tf2_tpu_torch.graph.init_params import init_params
from tf2_tpu_torch.models import get_model, synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.serve import ContinuousBatcher, InferenceServer, serve_http

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)
# The served logits against the reference server's: the port's
# global_avgpool sums in float64 (a chosen divergence, ROADMAP Queue 3);
# with the synthetic scales (0.02 in and out) its mean of 2x2 int8 values
# often lands on a rounding boundary of the quantize after it, which then
# differs by one quantum (114 of 4,096 elements here), and the fc's int8
# output by at most two quanta of 0.02 (measured on the CPU with these
# seeds: 0.0400001), with the same argmax.
RESNET_LOGITS_BOUND = 2 * 0.02 + 1e-6
WAIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _joined(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


# ---- the batcher: the reference's cases ----

def _echo_runner(calls):
    def run(batch):
        calls.append(batch.shape[0])
        return batch * 2.0
    return run


def test_batcher_roundtrip_and_order():
    calls = []
    b = ContinuousBatcher(_echo_runner(calls), batch_size=4,
                          example_shape=(3,), max_wait_s=0.01).start()
    futs = [b.submit(np.full((3,), i, np.float32)) for i in range(10)]
    outs = [f.result(5) for f in futs]
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full((3,), 2.0 * i))
    b.stop()
    s = b.stats()
    assert s["requests"] == 10
    assert s["batches"] >= 3  # 10 requests in batches of 4


def test_batcher_pads_lone_request():
    calls = []
    b = ContinuousBatcher(_echo_runner(calls), batch_size=8,
                          example_shape=(2,), max_wait_s=0.001).start()
    out = b.submit(np.ones((2,), np.float32)).result(5)
    np.testing.assert_array_equal(out, 2 * np.ones((2,)))
    b.stop()
    assert calls == [8]  # padded to the full batch
    assert b.stats()["avg_occupancy"] <= 0.5


def test_batcher_error_propagates():
    def boom(batch):
        raise RuntimeError("kaboom")
    b = ContinuousBatcher(boom, batch_size=2, example_shape=(1,)).start()
    fut = b.submit(np.zeros((1,), np.float32))
    with pytest.raises(RuntimeError, match="kaboom"):
        fut.result(5)
    b.stop(drain=False)


def test_batcher_rejects_bad_shape():
    b = ContinuousBatcher(lambda x: x, batch_size=2, example_shape=(4,))
    with pytest.raises(ValueError):
        b.submit(np.zeros((5,), np.float32))


def test_batcher_concurrent_clients():
    calls = []
    b = ContinuousBatcher(_echo_runner(calls), batch_size=8,
                          example_shape=(1,), max_wait_s=0.005).start()
    results = {}

    def client(i):
        results[i] = b.submit(np.full((1,), i, np.float32)).result(10)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    _joined(threads)
    b.stop()
    for i in range(32):
        np.testing.assert_array_equal(results[i], np.full((1,), 2.0 * i))
    assert len(calls) < 32  # batching happened


# ---- the batcher: the port's additions ----

def test_batcher_tuple_output_gives_each_request_its_rows():
    b = ContinuousBatcher(lambda x: (x + 1, x * 3), batch_size=4, example_shape=(2,),
                          max_wait_s=0.01).start()
    futs = [b.submit(np.full((2,), i, np.float32)) for i in range(6)]
    for i, f in enumerate(futs):
        first, second = f.result(5)
        np.testing.assert_array_equal(first, np.full((2,), i + 1.0))
        np.testing.assert_array_equal(second, np.full((2,), 3.0 * i))
    b.stop()


def test_batcher_stop_fails_queued_requests():
    """``stop(drain=False)`` on a batcher that never started: each queued
    request fails, none waits for ever."""
    b = ContinuousBatcher(lambda x: x, batch_size=2, example_shape=(1,))
    fut = b.submit(np.zeros((1,), np.float32))
    b.stop(drain=False)
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(5)


def test_batcher_stress_keeps_every_request():
    """More client threads than cores, the interpreter switching threads
    often: every request gets its own row, and the stats count each
    request and batch once."""
    n_threads, per_thread = 64, 10
    b = ContinuousBatcher(_echo_runner([]), batch_size=16, example_shape=(1,),
                          max_wait_s=0.0005).start()
    results, errors = {}, []

    def client(i):
        try:
            for j in range(per_thread):
                k = i * per_thread + j
                results[k] = float(b.submit(np.full((1,), k, np.float32)).result(WAIT_S)[0])
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        _joined(threads)
    finally:
        sys.setswitchinterval(prev)
    b.stop()
    assert not errors
    assert results == {k: 2.0 * k for k in range(n_threads * per_thread)}
    s = b.stats()
    assert s["requests"] == n_threads * per_thread
    assert s["avg_occupancy"] * s["batches"] * 16 == pytest.approx(s["requests"])


# ---- HTTP, the reference's end-to-end test on the port ----

def _url(httpd, path):
    return f"http://127.0.0.1:{httpd.server_address[1]}{path}"


def _post(httpd, body: bytes):
    req = urllib.request.Request(_url(httpd, "/predict"), data=body, method="POST")
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.load(r)


def _npy(x) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def test_http_server_end_to_end():
    """Full stack: the port's Engine on the CPU -> batcher -> HTTP
    predict, stats, healthz, and a malformed body answered with 400."""
    g = get_model("squeezenet_v1_1", batch=4, image=32, classes=10)
    srv = InferenceServer(Engine(g, init_params(g), device="cpu"), batch_size=4).start()
    httpd = serve_http(srv, port=0)
    try:
        assert httpd.server_address[1] != 0
        with urllib.request.urlopen(_url(httpd, "/healthz"), timeout=WAIT_S) as r:
            assert json.load(r)["ok"]
        out = _post(httpd, _npy(np.random.rand(32, 32, 3).astype(np.float32)))["output"]
        assert len(out) == 10
        with urllib.request.urlopen(_url(httpd, "/stats"), timeout=WAIT_S) as r:
            stats = json.load(r)
        assert stats["requests"] >= 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(httpd, b"garbage")
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


# ---- a served ResNet-50 against direct forwards and the reference ----

@pytest.fixture(scope="module")
def resnet():
    art = synthetic_quantized("resnet50", seed=0, **SMALL)
    eng = Engine(art.graph, art.params, device="cpu")
    x = np.random.default_rng(1).standard_normal((6, 64, 64, 3)).astype(np.float32)
    # each image's row of a direct forward on a batch holding it (images
    # 0-1, 2-3, 4-5; the server pairs them as the requests arrive)
    direct = np.concatenate([eng.run(image=x[i:i + 2]).numpy() for i in range(0, len(x), 2)])
    return dict(art=art, eng=eng, x=x, direct=direct)


def test_served_rows_equal_direct_forward(resnet):
    """Threads and HTTP at once; each response equals its image's row of
    the direct forward bit for bit."""
    srv = InferenceServer(resnet["eng"], batch_size=2).start()
    httpd = serve_http(srv, port=0)
    x, got = resnet["x"], {}
    try:
        def client(i):
            got[i] = srv.predict(x[i], timeout=WAIT_S)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(x))]
        for t in threads:
            t.start()
        over_http = [np.asarray(_post(httpd, _npy(x[i]))["output"], np.float32)
                     for i in (0, 3)]
        _joined(threads)
        with urllib.request.urlopen(_url(httpd, "/stats"), timeout=WAIT_S) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    for i in range(len(x)):
        assert got[i].dtype == np.float32
        np.testing.assert_array_equal(got[i], resnet["direct"][i], err_msg=f"image {i}")
    np.testing.assert_array_equal(over_http[0], resnet["direct"][0])
    np.testing.assert_array_equal(over_http[1], resnet["direct"][3])
    assert stats["requests"] == len(x) + 2
    assert stats["captured"] is False  # nothing captured on the CPU


def test_served_logits_against_reference_server(resnet):
    """The same images through the reference's InferenceServer (JAX CPU,
    its default Engine) and the port's: within the stated bound, the same
    argmax."""
    art, x = resnet["art"], resnet["x"]
    ref = RefInferenceServer(RefEngine(RefGraph.from_json(art.graph.to_json()),
                                       {k: np.asarray(v) for k, v in art.params.items()}),
                             batch_size=2).start()
    try:
        want = np.stack([ref.predict(xi, timeout=WAIT_S) for xi in x])
    finally:
        ref.stop()
    srv = InferenceServer(resnet["eng"], batch_size=2).start()
    try:
        got = np.stack([srv.predict(xi, timeout=WAIT_S) for xi in x])
    finally:
        srv.stop()
    assert got.shape == want.shape == (len(x), 64)
    assert np.abs(got - want).max() <= RESNET_LOGITS_BOUND
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ---- start(): what is built ----

def test_start_builds_the_engine(resnet, monkeypatch):
    calls = []
    eng = resnet["eng"]
    monkeypatch.setattr(eng, "build", lambda **kw: calls.append(kw) or eng)
    srv = InferenceServer(eng, batch_size=2).start()
    srv.stop()
    assert calls == [{}]


def test_start_builds_ssd(monkeypatch):
    """SSD (its NMS a kernel, nothing waiting on the host): ``start``
    builds the Engine as it builds every other, and each (100, 6)
    detection row equals a direct forward's."""
    art = synthetic_quantized("ssd", seed=0, batch=2, image=64)
    eng = Engine(art.graph, art.params, device="cpu")
    calls = []
    build = eng.build
    monkeypatch.setattr(eng, "build", lambda **kw: calls.append(kw) or build(**kw))
    x = np.random.default_rng(2).standard_normal((3, 64, 64, 3)).astype(np.float32)
    direct = eng.run(image=x[:2]).numpy()
    srv = InferenceServer(eng, batch_size=2).start()
    try:
        got = [srv.predict(xi, timeout=WAIT_S) for xi in x[:2]]
        stats = srv.stats()
    finally:
        srv.stop()
    assert calls == [{}]
    assert stats["captured"] is False  # nothing captured on the CPU
    for i in range(2):
        assert got[i].shape == (100, 6)
        np.testing.assert_array_equal(got[i], direct[i])
