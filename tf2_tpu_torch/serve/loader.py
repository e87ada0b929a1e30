"""Prefetching input pipeline: host-side double buffering, as the
reference's ``tf2_tpu/serve/loader.py`` (preprocess batch N+1 while batch N
is on the card).

``PrefetchLoader`` pulls raw items from a user source (paths, sockets, a
dataset iterator), preprocesses them on a background thread (by default
through the native C++ library, ``utils.preproc``: multithreaded resize,
normalize and int8 quantize in one pass), and keeps up to ``depth`` ready
batches in a bounded queue so the Engine does not wait on the host.

The Engine side consumes with ``for batch in loader:`` or explicit
``get()``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np


class PrefetchLoader:
    """Bounded prefetch queue of preprocessed batches.

    source: iterable of raw batches (lists of HWC uint8 arrays, paths, or
        anything ``preprocess`` accepts).
    preprocess: fn(raw_batch) -> np.ndarray device-ready batch. Defaults
        to the native preprocessing (``utils.preproc.preprocess``) of raw
        batches of uint8 images.
    depth: max ready batches held (2 = classic double buffering).
    """

    _DONE = object()

    def __init__(self, source: Iterable, preprocess: Callable | None = None,
                 depth: int = 2, out_size: int = 224,
                 quantize_scale: float | None = None):
        if preprocess is None:
            from ..utils import preproc as _pp

            def preprocess(raw):
                imgs = np.stack([np.asarray(r, np.uint8) for r in raw])
                return _pp.preprocess(imgs, out_size=out_size, quant_scale=quantize_scale)

        self._source = iter(source)
        self._fn = preprocess
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._started = False

    def _produce(self):
        try:
            for raw in self._source:
                if self._stop.is_set():
                    return
                batch = self._fn(raw)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # relayed to the consumer by get()
            self._err.append(e)
            if not isinstance(e, Exception):
                raise
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._DONE, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def start(self) -> "PrefetchLoader":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def get(self, timeout: float = 60.0):
        """Next ready batch, or None when the source is exhausted. Raises
        the producer's error, and ``queue.Empty`` after ``timeout``
        seconds without a batch."""
        self.start()
        item = self._q.get(timeout=timeout)
        if item is self._DONE:
            if self._err:
                raise self._err[0]
            return None
        return item

    def __iter__(self) -> Iterator:
        while True:
            item = self.get()
            if item is None:
                return
            yield item

    def stop(self):
        self._stop.set()

    @property
    def ready(self) -> int:
        return self._q.qsize()
