"""Serving layer: the port's Engine + continuous batcher + JSON/HTTP front
end + health and stats, as the reference's ``tf2_tpu/serve/server.py``.

- ``InferenceServer`` owns an Engine at a fixed batch size and a
  ContinuousBatcher feeding it. ``start()`` builds the Engine (one CUDA
  graph on the card, which the batcher's thread then replays; SSD's too,
  its NMS included), as the reference's server builds every Engine it
  serves; ``stats()["captured"]`` says whether a replay serves.
- Each batch's outputs come to the host once, in one copy a member; the
  batcher hands request ``i`` row ``i``.
- HTTP endpoints (stdlib ``http.server``): POST /predict with the raw
  ``.npy`` bytes of one example, GET /stats (qps, occupancy,
  p50/p95/p99), GET /healthz. ``serve_http(server, port=0)`` binds a free
  port: read it from ``httpd.server_address``.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..runtime.engine import Engine
from .batcher import ContinuousBatcher


def to_host(out):
    """An Engine's output (a tensor or a tuple of them) as numpy arrays."""
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy() for o in out)
    return out.cpu().numpy()


class InferenceServer:
    def __init__(self, engine: Engine, batch_size: int,
                 input_name: str = "image", max_wait_s: float = 0.002):
        self.engine = engine
        self.input_name = input_name
        spec = engine.graph.inputs[input_name]
        if spec.shape[0] != batch_size:
            raise ValueError(f"engine graph batch {spec.shape[0]} != server batch {batch_size}")
        self._example_shape = tuple(spec.shape[1:])
        self._dtype = np.dtype(spec.dtype)
        self.batcher = ContinuousBatcher(self._run, batch_size, self._example_shape,
                                         max_wait_s=max_wait_s, dtype=self._dtype)
        self._t_start = time.time()

    def _run(self, batch: np.ndarray):
        return to_host(self.engine.run(**{self.input_name: torch.from_numpy(batch)}))

    def start(self) -> "InferenceServer":
        self.engine.build()
        self.batcher.start()
        return self

    def predict(self, x: np.ndarray, timeout: float = 30.0):
        return self.batcher.submit(np.asarray(x, self._dtype)).result(timeout)

    def stats(self) -> dict:
        s = self.batcher.stats()
        s["uptime_s"] = time.time() - self._t_start
        s["qps"] = s["requests"] / max(s["uptime_s"], 1e-9)
        s["captured"] = self.engine.built
        return s

    def stop(self):
        self.batcher.stop()


def _jsonable(y):
    return [o.tolist() for o in y] if isinstance(y, tuple) else y.tolist()


def serve_http(server: InferenceServer, port: int = 8476) -> ThreadingHTTPServer:
    """Start the HTTP front end on a background thread; returns the httpd
    (its bound port is ``httpd.server_address[1]``; stop it with
    ``.shutdown()`` and ``.server_close()``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, server.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            try:  # a bad request or a failed forward: the client gets 400
                x = np.load(io.BytesIO(raw), allow_pickle=False)
                y = server.predict(x)
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {"output": _jsonable(y)})

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
