"""The artifact a cell serves, made by the benchmark from ``--seed``: the
configuration's quantized graph and its weights (``families``), drawn and
fitted on the device, written as the port's artifact directory
(``graph.json`` and ``weights.safetensors``, tensors largest dtype first,
sha256 prefixes in the metadata). It is kept per configuration and seed
under ``perfbench/.cache/artifacts/``, as a deployment keeps what its
offline transform wrote; the newest ``KEEP`` of each configuration stay."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
from pathlib import Path

import numpy as np
import torch

from . import families
from .seeds import derive

CACHE = Path(__file__).resolve().with_name(".cache") / "artifacts"
KEEP = 16
_CODES = {np.dtype(np.float32): "F32", np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8"}


def write_safetensors(path: Path, tensors: dict[str, np.ndarray]) -> None:
    arrays = {k: np.ascontiguousarray(v) for k, v in tensors.items()}
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.itemsize, k))
    hashes = {k: hashlib.sha256(arrays[k].tobytes()).hexdigest()[:16] for k in order}
    header: dict = {"__metadata__": {"hashes": json.dumps(hashes)}}
    offset = 0
    for k in order:
        a = arrays[k]
        header[k] = {"dtype": _CODES[a.dtype], "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            f.write(arrays[k].tobytes())


def make(cfg: dict, seed: int, device, cache: Path = CACHE) -> Path:
    """The directory of the configuration's artifact for ``seed``, written
    if it is not there yet."""
    out = cache / f"{cfg['name']}-{seed}"
    if (out / "weights.safetensors").exists():
        os.utime(out)
        return out
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    graph, params = families.build(cfg, gen, device)
    tmp = cache / f".{cfg['name']}-{seed}.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    (tmp / "graph.json").write_text(json.dumps(graph, indent=1))
    write_safetensors(tmp / "weights.safetensors",
                      {k: v.cpu().numpy() for k, v in params.items()})
    try:
        os.replace(tmp, out)
    except OSError:   # another process wrote the same artifact first
        if not (out / "weights.safetensors").exists():
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    _prune(cache, cfg["name"])
    return out


def _prune(cache: Path, name: str) -> None:
    dirs = sorted((d for d in cache.glob(f"{name}-*") if d.is_dir()),
                  key=lambda d: d.stat().st_mtime, reverse=True)
    for d in dirs[KEEP:]:
        shutil.rmtree(d, ignore_errors=True)
