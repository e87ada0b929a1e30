"""The NMS keep mask and SSD whole on the CPU: ``greedy_keep`` (on a CPU
tensor the plain fixpoint, ``greedy_keep_plain``) against the reference's
``nms_single_class`` (jnp, its tiled sweep under XLA, not Pallas) and
against a numpy model of ``csrc/nms.cu``'s greedy sweep (the kernel runs
only on the card), on the kernel's edge rows; SSD's ``Engine.build`` and
``InferenceServer.start`` on the CPU, the served rows equal to a direct
forward. Tolerance 0 throughout."""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.kernels import detection as ref_detection
from tf2_tpu_torch import kernels
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.kernels import detection
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.serve import InferenceServer

WAIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _ref_keep_fn(k: int, thresh: float):
    return jax.jit(lambda b, s: ref_detection.nms_single_class(b, s, k, thresh)[2])


def _ref_keep(boxes: np.ndarray, thresh: float) -> np.ndarray:
    """The reference's keep mask of one score-sorted row: strictly falling
    positive scores, so its top k is the row in order and no box is
    zeroed."""
    k = len(boxes)
    scores = np.linspace(1.0, 0.5, k, dtype=np.float32)
    return np.asarray(_ref_keep_fn(k, thresh)(jnp.asarray(boxes), jnp.asarray(scores)))


def _sweep(boxes: np.ndarray, thresh: float) -> np.ndarray:
    """csrc/nms.cu's algorithm in numpy f32 (each step one rounded f32
    operation, NaN propagated as torch's minimum, maximum and clamp_min):
    for i in order, a kept box i clears every later kept box whose IoU
    with it exceeds f32(thresh)."""
    b = boxes.astype(np.float32)
    zero, t = np.float32(0), np.float32(thresh)
    area = np.maximum(b[:, 2] - b[:, 0], zero) * np.maximum(b[:, 3] - b[:, 1], zero)
    keep = np.ones(len(b), bool)
    for i in range(len(b) - 1):
        if not keep[i]:
            continue
        j = slice(i + 1, None)
        iw = np.maximum(np.minimum(b[i, 2], b[j, 2]) - np.maximum(b[i, 0], b[j, 0]), zero)
        ih = np.maximum(np.minimum(b[i, 3], b[j, 3]) - np.maximum(b[i, 1], b[j, 1]), zero)
        inter = iw * ih
        iou = inter / np.maximum(area[i] + area[j] - inter, np.float32(1e-9))
        keep[j] &= ~(iou > t)
    return keep


def _row(kind: str, k: int, seed: int = 0) -> np.ndarray:
    """One (k, 4) f32 xyxy row of a kind (as tests/test_torch_cuda.py's
    ``_nms_rows``): random corners, SSD-like boxes around a coarse grid of
    centres, all zero, one box repeated, a chain whose boxes overlap only
    their neighbours above 0.45 (IoU 0.54, then 0.25), or IoUs exactly at
    the thresholds (1 / 2 and f32(0.1) = 1 / 10)."""
    rng = np.random.default_rng(seed + k)
    if kind == "random":
        lo = rng.uniform(0, 1, (k, 2))
        return np.concatenate([lo, lo + rng.uniform(0, 0.5, (k, 2))], -1).astype(np.float32)
    if kind == "ssd":
        c = rng.integers(0, 4, (k, 2)) / 4 + rng.normal(0, 0.02, (k, 2))
        wh = rng.uniform(0.1, 0.4, (k, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if kind == "zero":
        return np.zeros((k, 4), np.float32)
    if kind == "same":
        return np.tile(np.float32([0.1, 0.2, 0.5, 0.7]), (k, 1))
    if kind == "chain":
        x = np.arange(k, dtype=np.float32) * np.float32(0.3)
        return np.stack([x, 0 * x, x + 1, 0 * x + 1], -1).astype(np.float32)
    if kind == "at_threshold":
        base = np.float32([[0, 0, 1, 1], [0, 0, 2, 1], [0, 0, 10, 1]])
        return np.tile(base, (-(-k // 3), 1))[:k]
    raise KeyError(kind)


ROWS = [(kind, k) for k in (1, 31, 100, 200, 257) for kind in ("random", "ssd")] + [
    ("random", 1008), ("ssd", 1008), ("zero", 200), ("same", 200), ("chain", 200),
    ("chain", 257), ("at_threshold", 3), ("at_threshold", 31)]


@pytest.mark.parametrize("kind,k", ROWS)
@pytest.mark.parametrize("thresh", [0.45, 0.5, 0.1])
def test_greedy_keep_equals_reference(kind, k, thresh):
    """The port's keep mask (the plain fixpoint on the CPU) equals the
    reference's tiled sweep and the kernel's greedy sweep, on the kernel's
    edge rows: k 1, 31 (under a warp), 100 (SSD's: min(100, priors)), 200,
    257 (above the block), 1,008 (SSD's priors); zero boxes, identical
    boxes, a deep chain, IoUs exactly at the threshold."""
    boxes = _row(kind, k)
    kernels.reset_launch_counts()
    got = detection.greedy_keep(torch.as_tensor(boxes), thresh).numpy()
    assert kernels.launch_counts()["nms"] == 0  # the CPU takes the plain version
    np.testing.assert_array_equal(got, _ref_keep(boxes, thresh))
    np.testing.assert_array_equal(got, _sweep(boxes, thresh))


def test_greedy_keep_edge_rows_keep_what_greedy_keeps():
    """What greedy NMS must keep on the edge rows, known without running
    it: a zero row keeps every box (IoU 0), a repeated box only its first,
    the chain every other box at 0.45 and every third at 0.1, and the IoUs
    at the threshold keep their boxes (compared in f32: f32(0.1) > 0.1 is
    false)."""
    keep = {kind: detection.greedy_keep(torch.as_tensor(_row(kind, 200)), 0.45)
            for kind in ("zero", "same", "chain")}
    assert keep["zero"].all()
    assert keep["same"][0] and not keep["same"][1:].any()
    assert keep["chain"][::2].all() and not keep["chain"][1::2].any()
    chain01 = detection.greedy_keep(torch.as_tensor(_row("chain", 200)), 0.1)
    assert chain01[::3].all() and chain01.sum() == 67
    at = torch.as_tensor(_row("at_threshold", 3))  # IoUs 1/2 (0-1), 1/10 (0-2), 1/5 (1-2)
    assert detection.greedy_keep(at, 0.5).all()
    assert detection.greedy_keep(at, 0.1).tolist() == [True, False, True]
    assert detection.greedy_keep(at, 0.0999).tolist() == [True, False, False]


def test_greedy_keep_batches_rows_and_passes_shapes():
    """Leading axes are rows (as the (N, C - 1, k) rows of ``batched_nms``),
    each row its own sweep; the ``meta`` shape pass gives the shape."""
    rows = np.stack([np.stack([_row(kind, 31, seed) for seed in range(3)])
                     for kind in ("random", "ssd", "chain")])
    got = detection.greedy_keep(torch.as_tensor(rows), 0.45).numpy()
    assert got.shape == (3, 3, 31)
    for i in range(3):
        for j in range(3):
            np.testing.assert_array_equal(got[i, j], _sweep(rows[i, j], 0.45))
    meta = detection.greedy_keep(torch.empty((2, 5, 31, 4), device="meta"), 0.45)
    assert meta.shape == (2, 5, 31) and meta.dtype == torch.bool


def test_class_rows_feed_batched_nms():
    """``batched_nms`` sweeps ``class_rows``: the (N, C - 1, k) rows of
    sorted candidates, contiguous as the kernel takes them, the boxes of
    zero scores zeroed; its kept scores are those rows' under the keep
    mask."""
    rng = np.random.default_rng(3)
    boxes = torch.as_tensor(_row("ssd", 64, 1)[None].repeat(2, 0))
    scores = torch.softmax(torch.as_tensor(rng.normal(0, 2, (2, 64, 5)), dtype=torch.float32), -1)
    bk, sk = detection.class_rows(boxes, scores, topk=40, score_thresh=0.2)
    assert bk.shape == (2, 4, 40, 4) and sk.shape == (2, 4, 40) and bk.is_contiguous()
    assert (bk[sk == 0] == 0).all() and (sk[..., :-1] >= sk[..., 1:]).all()
    kept = torch.where(detection.greedy_keep(bk, 0.45), sk, torch.zeros_like(sk))
    dets = detection.batched_nms(boxes, scores, max_out=160, topk=40, iou_thresh=0.45,
                                 score_thresh=0.2)
    assert torch.equal(dets[..., 4].sort(-1).values, kept.reshape(2, -1).sort(-1).values)


@pytest.fixture(scope="module")
def ssd():
    art = synthetic_quantized("ssd", seed=0, batch=2, image=64)
    x = np.random.default_rng(4).standard_normal((4, 64, 64, 3)).astype(np.float32)
    return art, x


def test_ssd_engine_builds_on_cpu(ssd):
    """SSD's Engine builds (on the CPU the warm-up forward alone), and its
    detections equal the plain path's (the nms node on its plain flag)."""
    art, x = ssd
    eng = Engine(art.graph, art.params, device="cpu")
    assert eng.build(image=x[:2]) is eng and not eng.built
    got = eng.run(image=x[:2])
    want = execute(eng.graph, plain=True)(eng.params, image=torch.as_tensor(x[:2]))
    assert tuple(got.shape) == (2, 100, 6) and torch.equal(got, want)


def test_ssd_server_starts_built_and_serves_direct_rows(ssd, monkeypatch):
    """``InferenceServer.start`` builds SSD's Engine; each served (100, 6)
    detection row equals its row of a direct forward."""
    art, x = ssd
    eng = Engine(art.graph, art.params, device="cpu")
    direct = np.concatenate([eng.run(image=x[i:i + 2]).numpy() for i in (0, 2)])
    built = []
    build = eng.build
    monkeypatch.setattr(eng, "build", lambda **kw: built.append(kw) or build(**kw))
    srv = InferenceServer(eng, batch_size=2).start()
    got = {}

    def client(i):
        got[i] = srv.predict(x[i], timeout=WAIT_S)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(x))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        alive = [t for t in threads if t.is_alive()]
    finally:
        srv.stop()
    assert built == [{}] and not alive and sorted(got) == list(range(len(x)))
    for i in range(len(x)):
        assert got[i].shape == (100, 6)
        np.testing.assert_array_equal(got[i], direct[i], err_msg=f"image {i}")
