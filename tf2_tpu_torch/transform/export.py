"""Artifact IO: ``<dir>/graph.json`` (versioned IR) +
``<dir>/weights.safetensors`` (flat tensor dict, sha256[:16] hashes in the
metadata).

The safetensors format is read and written here directly: an 8-byte
little-endian header length, a JSON header mapping each tensor name to its
``dtype``, ``shape`` and ``data_offsets`` (plus ``__metadata__``), then the
raw little-endian tensor bytes. Files written here load with the
``safetensors`` package and the other way round.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

from ..graph.ir import Graph
from ..runtime import spans

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
           "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
           "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
           "BOOL": np.bool_}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def write_safetensors(path: str, tensors: dict[str, np.ndarray],
                      metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` in the safetensors layout: larger dtypes first, then
    by name, as the safetensors package orders them."""
    arrays = {k: np.ascontiguousarray(v) for k, v in tensors.items()}
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.itemsize, k))
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for k in order:
        a = arrays[k]
        if a.dtype not in _CODES:
            raise ValueError(f"tensor {k!r}: dtype {a.dtype} has no safetensors code")
        header[k] = {"dtype": _CODES[a.dtype], "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            f.write(arrays[k].astype(arrays[k].dtype.newbyteorder("<"),
                                     copy=False).tobytes())


def read_safetensors(path: str) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """-> (tensors, metadata) from a safetensors file."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    metadata = header.pop("__metadata__", None) or {}
    body = memoryview(data)[8 + n:]
    tensors = {}
    for k, info in header.items():
        lo, hi = info["data_offsets"]
        dt = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        a = np.frombuffer(body[lo:hi], dtype=dt).reshape(info["shape"])
        tensors[k] = a.astype(a.dtype.newbyteorder("="))
    return tensors, metadata


def save_artifact(path: str, graph: Graph, params: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "graph.json"), "w") as f:
        f.write(graph.to_json())
    np_params = {k: np.asarray(v) for k, v in params.items()}
    hashes = {k: _hash(v) for k, v in np_params.items()}
    write_safetensors(os.path.join(path, "weights.safetensors"), np_params,
                      metadata={"hashes": json.dumps(hashes)})


@spans.span("artifact.load")
def load_artifact(path: str, verify_hashes: bool = True
                  ) -> tuple[Graph, dict[str, np.ndarray]]:
    """Read an artifact directory written by either package: a set-up span,
    ``artifact.load`` (``runtime/spans.py``)."""
    with open(os.path.join(path, "graph.json")) as f:
        graph = Graph.from_json(f.read())
    params, meta = read_safetensors(os.path.join(path, "weights.safetensors"))
    if verify_hashes:
        hashes = json.loads(meta.get("hashes", "{}"))
        for k, v in params.items():
            if k in hashes and _hash(v) != hashes[k]:
                raise ValueError(f"tensor hash mismatch for {k!r} — corrupt artifact")
    missing = set(graph.params) - set(params)
    if missing:
        raise ValueError(f"artifact missing params: {sorted(missing)[:5]}...")
    return graph, params


def save_quantized(path: str, art) -> None:
    """Write a ``QuantizedArtifact`` as an artifact directory."""
    save_artifact(path, art.graph, art.params)


def from_reference(graph_json: str, params: dict) -> tuple[Graph, dict[str, np.ndarray]]:
    """Build the port's Graph from a ``tf2_tpu`` graph's JSON and take its
    params (any array-likes) as numpy arrays, unchanged."""
    graph = Graph.from_json(graph_json)
    return graph, {k: np.asarray(v) for k, v in params.items()}
