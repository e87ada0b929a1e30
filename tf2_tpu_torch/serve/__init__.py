"""Serving on the port's Engine: ``ContinuousBatcher``, ``InferenceServer``
and ``serve_http`` (``loader.PrefetchLoader`` for the input pipeline)."""
from .batcher import ContinuousBatcher
from .server import InferenceServer, serve_http
