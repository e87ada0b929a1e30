"""Reads an artifact directory (``graph.json`` and ``weights.safetensors``)
with the standard library and numpy."""
from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_DTYPES = {"F64": np.float64, "F32": np.float32, "I64": np.int64, "I32": np.int32,
           "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path) -> dict[str, np.ndarray]:
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    body = memoryview(data)[8 + n:]
    out = {}
    for k, info in header.items():
        lo, hi = info["data_offsets"]
        a = np.frombuffer(body[lo:hi], dtype=np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<"))
        out[k] = a.reshape(info["shape"]).astype(a.dtype.newbyteorder("="))
    return out


def graph(path) -> dict:
    """The parsed ``graph.json``."""
    return json.loads((Path(path) / "graph.json").read_text())


def load(path) -> tuple[dict, dict[str, np.ndarray]]:
    """-> (the parsed graph.json, {param name: array})."""
    return graph(path), read_safetensors(Path(path) / "weights.safetensors")
