"""Continuous batcher: groups single inference requests into fixed-shape
batches for an Engine built at one batch size (``Engine.build`` captures
the forward at that shape), as the reference's ``tf2_tpu/serve/batcher.py``.

The batcher fills up to B requests a step, pads the tail with zeros, and
runs steps back to back so the card never idles while requests are queued.
``max_wait_s`` bounds how long a lone request waits for co-riders.
``run_batch`` may return one array or a tuple of arrays, each with the
batch on its first axis: request ``i`` gets row ``i`` (of each member).
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

STOP_TIMEOUT_S = 30.0  # the most stop() waits for the queue to drain, then the loop


@dataclass
class BatcherStats:
    requests: int = 0
    batches: int = 0
    occupancy_sum: float = 0.0
    latency_sum_s: float = 0.0
    latencies: collections.deque = field(  # the newest 1,024
        default_factory=lambda: collections.deque(maxlen=1024))

    def snapshot(self) -> dict:
        lat = sorted(self.latencies)

        def pct(p):
            return lat[min(int(len(lat) * p), len(lat) - 1)] if lat else 0.0

        return {
            "requests": self.requests,
            "batches": self.batches,
            "avg_occupancy": self.occupancy_sum / max(self.batches, 1),
            "avg_latency_s": self.latency_sum_s / max(self.requests, 1),
            "p50_s": pct(0.50), "p95_s": pct(0.95), "p99_s": pct(0.99),
        }


class ContinuousBatcher:
    """Wraps a callable ``run_batch(np.ndarray[B, ...]) -> np.ndarray[B, ...]``
    (or a tuple of them) behind an async ``submit()`` API with dynamic
    batching."""

    def __init__(self, run_batch, batch_size: int, example_shape: tuple,
                 max_wait_s: float = 0.002, dtype=np.float32):
        self.run_batch = run_batch
        self.batch_size = batch_size
        self.example_shape = tuple(example_shape)
        self.max_wait_s = max_wait_s
        self.dtype = dtype
        self._q: queue.Queue = queue.Queue()
        self._stats = BatcherStats()
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._started = False

    # ---- client API ----
    def start(self) -> "ContinuousBatcher":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def submit(self, x: np.ndarray) -> Future:
        if x.shape != self.example_shape:
            raise ValueError(f"expected {self.example_shape}, got {x.shape}")
        fut: Future = Future()
        self._q.put((x, fut, time.perf_counter()))
        return fut

    def stop(self, drain: bool = True):
        """Stop the loop: with ``drain``, first wait (at most
        ``STOP_TIMEOUT_S``) until every queued request has been taken.
        Requests still queued then fail with a RuntimeError."""
        if drain and self._started:
            deadline = time.perf_counter() + STOP_TIMEOUT_S
            while not self._q.empty() and time.perf_counter() < deadline:
                time.sleep(0.001)
        self._stop.set()
        if self._started:
            self._thread.join(timeout=STOP_TIMEOUT_S)
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("the batcher stopped before this request ran"))

    def stats(self) -> dict:
        with self._stats_lock:
            return self._stats.snapshot()

    # ---- batching loop ----
    def _collect(self) -> list:
        """Block for the first request, then fill the batch for up to
        max_wait_s (or instantly if the queue already has riders)."""
        items = []
        try:
            items.append(self._q.get(timeout=0.05))
        except queue.Empty:
            return items
        deadline = time.perf_counter() + self.max_wait_s
        while len(items) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0 and self._q.empty():
                break
            try:
                items.append(self._q.get(timeout=max(remaining, 0.0001)))
            except queue.Empty:
                break
        return items

    def _loop(self):
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            n = len(items)
            try:
                batch = np.zeros((self.batch_size,) + self.example_shape, self.dtype)
                for i, (x, _, _) in enumerate(items):
                    batch[i] = x
                out = self.run_batch(batch)
                rows = (tuple(np.asarray(o) for o in out) if isinstance(out, tuple)
                        else np.asarray(out))
            except Exception as e:  # relayed to every caller of the batch
                for _, fut, _ in items:
                    fut.set_exception(e)
                continue
            now = time.perf_counter()
            for i, (_, fut, _) in enumerate(items):
                fut.set_result(tuple(o[i] for o in rows) if isinstance(rows, tuple)
                               else rows[i])
            with self._stats_lock:
                for _, _, t0 in items:
                    self._stats.latencies.append(now - t0)
                    self._stats.latency_sum_s += now - t0
                self._stats.requests += n
                self._stats.batches += 1
                self._stats.occupancy_sum += n / self.batch_size
