"""Image preprocessing: a ctypes binding to the native C++ library
(``native/preproc.cpp``) and an exact numpy reference.

Semantics (both paths): bilinear resize with half-pixel centers from HWC
uint8, per-channel ``(v/255 - mean)/std`` normalize, optional symmetric
int8 quantize ``clip(round(v/scale))``.

The library is compiled here, from the source, at first use (never at
import): ``g++`` with ``native/Makefile``'s flags into ``utils/build/``
(not tracked by git), named by a digest of the source, the flags and the
host's resolved ``-march=native`` target, so an edited source or another
host's CPU gets its own build. The ``.so`` that ``native/`` ships is
neither loaded nor rebuilt: it was built with ``-march=native`` on another
host. If the build or the load fails, ``preprocess`` raises; only
``force_numpy=True`` takes the numpy path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "preproc.cpp"
BUILD_DIR = Path(__file__).with_name("build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")  # native/Makefile
ABI_VERSION = 1

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("preproc: no C++ compiler (g++) to build native/preproc.cpp")
    return cxx


@functools.lru_cache(maxsize=4)
def _march(cxx: str) -> tuple[tuple[str, ...], str]:
    """(``-march=native`` where the compiler takes it, as the Makefile
    does; the target it resolves to on this host)."""
    r = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        return (), platform.machine()
    return ("-march=native",), r.stdout


def library_path() -> Path:
    """Where this host's build of the library lies (built or not)."""
    cxx = _cxx()
    march, target = _march(cxx)
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((Path(cxx).name,) + CXX_FLAGS + march).encode())
    h.update(target.encode())
    return BUILD_DIR / f"libtf2preproc-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/preproc.cpp`` unless this host's build exists;
    returns the library's path. Raises on a compiler error."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _cxx()
    march, _ = _march(cxx)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, *march, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"preproc: {cxx} failed on {SOURCE}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built at first use), its ABI checked and its
    argtypes declared. Raises if it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.preproc_abi_version.restype = ctypes.c_int
            lib.preproc_abi_version.argtypes = []
            if lib.preproc_abi_version() != ABI_VERSION:
                raise RuntimeError(f"preproc: ABI {lib.preproc_abi_version()}, "
                                   f"expected {ABI_VERSION}")
            fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            ci = ctypes.c_int
            lib.preproc_batch_f32.argtypes = [u8, ci, ci, ci, ci, ci, ci, fp, fp, fp, ci]
            lib.preproc_batch_f32.restype = None
            lib.preproc_batch_i8.argtypes = [u8, ci, ci, ci, ci, ci, ci, fp, fp,
                                             ctypes.c_float, i8, ci]
            lib.preproc_batch_i8.restype = None
            _lib = lib
        return _lib


def have_native() -> bool:
    """Does the library build and load on this host? (``preprocess``
    raises where it does not.)"""
    try:
        library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def f32_error_bound(in_h: int, in_w: int) -> float:
    """The most the native f32 output may differ from the numpy reference
    for an ``in_h`` x ``in_w`` input. The library takes each sample
    coordinate in float32 (``(o + 0.5f) * sy - 0.5f``, ``sy`` rounded too):
    three roundings of at most 2^-24 relative on a coordinate below the
    input's size, where numpy's are float64. Bilinear interpolation of uint8
    data moves at most 255 a unit of each coordinate, the float32 blend
    adds at most 9 roundings of a value at most 255, and the normalize,
    the same float32 steps in both, divides by 255 * std (ImageNet's) and
    rounds three times more (ulps of an output below 4). The reference
    test's 1e-4 holds at its sizes (37x53 -> 32); a 256x256 input allows
    4.1e-4 (measured 1.32e-4 at 256 -> 224, in this library and in the
    reference's own)."""
    u = 2.0 ** -24
    pixel = 255 * 3 * u * (in_h + in_w) + 9 * u * 255
    return float(pixel / (255 * IMAGENET_STD.min()) + 3 * np.spacing(np.float32(4.0)))


def _np_resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-center bilinear, HWC float64 for exactness."""
    h, w, c = img.shape
    ys = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    imgf = img.astype(np.float32)
    v00 = imgf[y0c][:, x0c]
    v01 = imgf[y0c][:, x1c]
    v10 = imgf[y1c][:, x0c]
    v11 = imgf[y1c][:, x1c]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy) +
            (v10 * (1 - fx) + v11 * fx) * fy).astype(np.float32)


def preprocess(batch_u8: np.ndarray, out_size: int,
               mean: np.ndarray = IMAGENET_MEAN,
               std: np.ndarray = IMAGENET_STD,
               quant_scale: float | None = None,
               n_threads: int = 0, force_numpy: bool = False) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, out, out, C) float32 (or int8 when
    ``quant_scale`` is given), through the native library, or the numpy
    reference with ``force_numpy=True``."""
    batch_u8 = np.ascontiguousarray(batch_u8, np.uint8)
    n, h, w, c = batch_u8.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if not force_numpy:
        if mean.shape != (c,) or std.shape != (c,):
            raise ValueError(f"mean {mean.shape} and std {std.shape} must be ({c},)")
        lib = library()
        nt = n_threads or min(os.cpu_count() or 1, 16)
        if quant_scale is None:
            out = np.empty((n, out_size, out_size, c), np.float32)
            lib.preproc_batch_f32(batch_u8, n, h, w, c, out_size, out_size, mean, std, out, nt)
        else:
            out = np.empty((n, out_size, out_size, c), np.int8)
            lib.preproc_batch_i8(batch_u8, n, h, w, c, out_size, out_size, mean, std,
                                 ctypes.c_float(quant_scale), out, nt)
        return out
    outs = []
    for i in range(n):
        r = _np_resize_bilinear(batch_u8[i], out_size, out_size)
        v = (r / 255.0 - mean) / std
        outs.append(v)
    out = np.stack(outs).astype(np.float32)
    if quant_scale is not None:
        out = np.clip(np.round(out / quant_scale), -127, 127).astype(np.int8)
    return out
