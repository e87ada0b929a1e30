"""Builds the CUDA sources under ``csrc/`` with nvcc for sm_90a into shared
libraries with a plain C interface, and loads them with ctypes.

The build runs at first use, one nvcc process per source, all started
together. Outputs go to ``kernels/build/`` (not tracked by git), named by a
digest of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("shift_matmul.cu", "qconv.cu", "qblocks.cu", "qlrn.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel. Returns
    source -> library path. nvcc's ptxas report (registers, spills) goes to
    ``build/<stem>.log``. Raises on any compiler error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in SOURCES}
    jobs = {}
    for src, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs[src] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{Path(src).stem}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``."""
    if source not in _LIBS:
        _LIBS[source] = ctypes.CDLL(str(build_all()[source]))
    return _LIBS[source]


@functools.lru_cache(maxsize=256)
def scalar(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-dim f32 tensor on ``device``. Dividing by it is a
    true division on the card too: CUDA divides by a host scalar as a
    multiplication by its reciprocal, which rounds differently."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def check_operands(device: torch.device, **tensors: tuple[torch.Tensor, torch.dtype, tuple]):
    """Raise unless each tensor lies on ``device`` (the current CUDA
    device), has the given dtype and shape and is contiguous. ``tensors``
    maps a name to (tensor, dtype, shape)."""
    if device.type != "cuda":
        raise ValueError(f"kernel launch needs a CUDA tensor, got {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def check_launch(rc: int, kernel: str) -> None:
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
