"""Builds the CUDA sources under ``csrc/`` with nvcc for sm_90a into shared
libraries with a plain C interface, and loads them with ctypes.

The build runs at first use, one nvcc process per source, all started
together. Outputs go to ``kernels/build/`` (not tracked by git), or to the
directory that ``TF2TPU_TORCH_KERNEL_CACHE`` names, named by a digest of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..runtime import spans

CSRC = Path(__file__).with_name("csrc")
CACHE_ENV = "TF2TPU_TORCH_KERNEL_CACHE"
DEFAULT_BUILD_DIR = Path(__file__).with_name("build")
BUILD_DIR = Path(os.environ.get(CACHE_ENV) or DEFAULT_BUILD_DIR)
SOURCES = ("shift_matmul.cu", "qconv.cu", "qblocks.cu", "qlrn.cu", "qattention.cu",
           "qstem.cu", "nms.cu", "qlayernorm.cu", "qdwconv.cu")
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


@spans.span("kernels.build_all")
def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel. Returns
    source -> library path. nvcc's ptxas report (registers, spills) goes to
    ``build/<stem>.log``. Raises on any compiler error. A set-up span,
    ``kernels.build_all``; each nvcc job counts in ``kernels.compiled``
    (``runtime/spans.py``)."""
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
        spans.count("kernels.compiled")
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
    """The loaded library built from ``csrc/<source>``; its first load is a
    set-up span, ``kernels.open``."""
    if source not in _LIBS:
        path = build_all()[source]
        with spans.span("kernels.open"):
            _LIBS[source] = ctypes.CDLL(str(path))
    return _LIBS[source]


def f32(value: float) -> float:
    """``value`` rounded once to f32, as a Python float: how every kernel
    and plain version takes a node's double scalar."""
    return float(np.float32(value))


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The f32 square root of an f32 tensor, correctly rounded on every
    device and thread, as the kernels' ``__fsqrt_rn``, for every normal or
    zero input. ``torch.sqrt`` on f32 is not correctly rounded in every CPU
    build (some take a vectorized approximation, whose result also varies
    with the tensor's address). The root is taken in float64 and rounded to
    f32 (correctly rounded under round-to-nearest: 53 >= 2 * 24 + 2 bits),
    then checked in exact arithmetic, so a thread whose FP control state
    rounds otherwise cannot move it: the correctly rounded r is the f32
    whose two midpoints with its neighbours bracket sqrt(x), m_lo^2 <= x <=
    m_hi^2 (never equal for an f32 x), and each midpoint (25 bits) and its
    square (50 bits) are exact in float64 in any rounding mode. A first
    guess at most one ulp off then steps once to its neighbour."""
    x = t.to(torch.float64)
    r = torch.sqrt(x).to(torch.float32)
    lo = torch.nextafter(r, torch.zeros_like(r))
    hi = torch.nextafter(r, torch.full_like(r, float("inf")))
    r64 = r.to(torch.float64)
    m_lo = (lo.to(torch.float64) + r64) * 0.5
    m_hi = (r64 + hi.to(torch.float64)) * 0.5
    return torch.where(x < m_lo * m_lo, lo, torch.where(x > m_hi * m_hi, hi, r))


@functools.lru_cache(maxsize=256)
def scalar(value: float, device: torch.device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``device`` (f32 unless ``dtype``).
    Dividing by it is a true division on the card too: CUDA divides by a
    host scalar as a multiplication by its reciprocal, which rounds
    differently. Cached: a new one is a copy to the card, which waits for
    the work queued before it."""
    return torch.tensor(value, dtype=dtype, device=device)


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


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as the pointer a launch takes,
    from torch's own accessor (``torch.cuda.current_stream`` builds a
    Stream object, 3.6 us a call on the card's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_launch(rc: int, kernel: str) -> None:
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
