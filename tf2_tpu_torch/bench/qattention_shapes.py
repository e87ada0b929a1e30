"""Times the qattention kernel at other shapes than the ones it ships with,
on one card, in one process:

    python -m tf2_tpu_torch.bench.qattention_shapes

``csrc/qattention.cu`` picks its shape from T: one pass with 8 query rows a
warp and 256 keys in registers (``OnePass``) up to T = 256, else three
passes over chunks of 64 keys with 16 rows a warp (``ThreePass``). Here
the source is rebuilt (nvcc, into a temporary directory) with both
aliases set to one (rows, keys) shape for each of SHAPES, and every build,
the shipped one first, runs ViT-B/16's attention at 224x224 and 384x384
(batch 64, 8 and 1) on the same random qkv: 0 mismatches against
``qattention_plain`` required, times with CUDA events. Prints one JSON
line with the card's name and power limit.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from tf2_tpu_torch.kernels import build, qattention

from .qattention_ab import S_IN, S_OUT, cuda_ms

# (rows a warp, keys a chunk) for both of the kernel's shapes
SHAPES = [(8, 64), (8, 128), (8, 256), (16, 64), (16, 128), (16, 256)]
CASES = [(64, 196), (64, 577), (8, 577), (1, 196), (1, 577)]  # (N, T), 12 heads of 64
_ONE, _THREE = "using OnePass = Cfg<HD, 1, kOnePass>;", "using ThreePass = Cfg<HD, 2, 64>;"


def _build(rows: int, keys: int, out: Path) -> ctypes.CDLL:
    src = (build.CSRC / "qattention.cu").read_text()
    if _ONE not in src or _THREE not in src:
        raise RuntimeError("csrc/qattention.cu no longer declares its two shapes as expected")
    shape = f"Cfg<HD, {rows // 8}, {keys}>;"
    src = src.replace(_ONE, "using OnePass = " + shape)
    src = src.replace(_THREE, "using ThreePass = " + shape)
    (out / "qattention.cu").write_text(src)
    lib = out / "qattention.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                    str(out / "qattention.cu")], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.tf2_qattention.argtypes = qattention._SIG
    cdll.tf2_qattention.restype = ctypes.c_int
    return cdll


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("qattention_shapes: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    qkv = {c: torch.as_tensor(rng.integers(-127, 128, (c[0], c[1], 3 * 768), dtype=np.int8)).cuda()
           for c in CASES}
    kw = dict(heads=12, dim=768, s_in=S_IN, s_out=S_OUT)
    want = {c: qattention.qattention_plain(x, **kw) for c, x in qkv.items()}
    qk, pv = qattention.scales(12, 768, S_IN, S_OUT)
    rows, failed = [], False
    with tempfile.TemporaryDirectory() as d:
        dirs = [Path(d) / f"{r}x{k}" for r, k in SHAPES]
        for p in dirs:
            p.mkdir()
        with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
            libs = list(pool.map(lambda a: _build(*a), [(*s, p) for s, p in zip(SHAPES, dirs)]))
        for shape, lib in [("shipped", qattention._lib()), *zip(SHAPES, libs)]:
            row = {"shape": shape}
            for (n, t), x in qkv.items():
                y = torch.empty_like(want[(n, t)])

                def run():
                    return lib.tf2_qattention(x.data_ptr(), y.data_ptr(), n, t, 12, 64, qk, pv,
                                              None, torch.cuda.current_stream().cuda_stream)

                ms = cuda_ms(run, 20)
                mismatches = int((y != want[(n, t)]).sum())
                failed |= mismatches > 0
                row[f"b{n} T{t}"] = {"ms": ms, "mismatches": mismatches}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
