"""Times the qattention kernel against another revision of its source on
one card, in one process:

    python -m tf2_tpu_torch.bench.qattention_ab --parent PATH/qattention.cu

``--parent`` is a ``csrc/qattention.cu`` of another revision with the same
C entry point (``tf2_qattention``); it is built with nvcc into a temporary
directory (against this checkout's ``csrc/`` headers) and never kept. At
each shape (ViT-B/16's at 224x224 and 384x384, with and without the class
token, batch 64 and 1) both kernels run on the same random qkv, are held
against ``qattention_plain`` (0 mismatches, or the shape is reported as not
taken where the parent refuses it), and are timed with CUDA events in the
order parent, this, this, parent, beside the plain version, bf16
``F.scaled_dot_product_attention`` on the dequantized q, k, v and the
bound; the share of elements whose division took the kernel's exact
steps is counted. Prints one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tf2_tpu_torch.kernels import build, qattention

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same source
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores, same source
H100_F64_OPS_PER_S = 34e12     # f64 outside the tensor cores, same source
# (N, T, heads, hd): vit_b16 and vit_b16_cls at 224x224, then at 384x384
SHAPES = [(64, 196, 12, 64), (64, 197, 12, 64), (64, 576, 12, 64), (64, 577, 12, 64),
          (1, 196, 12, 64), (1, 197, 12, 64), (1, 577, 12, 64), (8, 577, 12, 64)]
S_IN, S_OUT = 0.02, 0.02  # the synthetic artifacts' activation scale


def bound_ms(n: int, t: int, heads: int, dim: int) -> tuple[float, float]:
    """(bytes over the memory rate, operations over their peak rate) in ms:
    the int8 qkv read once and the output written once; per head 2 * T * T
    * hd int8 multiply-adds (QK^T and PV, 2 operations each), and per score
    6 f32 operations (the scale, the max, the subtraction, the division,
    * 127, the round) and 2 in f64 (the exp, counted as one, and the row
    sum's add)."""
    scores = n * heads * t * t
    int8_ops = 2 * 2 * scores * (dim // heads)
    ops_ms = (int8_ops / H100_INT8_OPS_PER_S + 6 * scores / H100_F32_OPS_PER_S
              + 2 * scores / H100_F64_OPS_PER_S) * 1e3
    return n * t * 4 * dim / H100_BYTES_PER_S * 1e3, ops_ms


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_parent(source: Path, out_dir: Path) -> ctypes.CDLL:
    lib_path = out_dir / "qattention_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                    str(lib_path), str(source)], check=True, stdout=sys.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.tf2_qattention.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.tf2_qattention.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qattention_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    rng = np.random.default_rng(0)
    rows = []
    with tempfile.TemporaryDirectory() as d:
        parent = build_parent(args.parent, Path(d))
        for n, t, heads, hd in SHAPES:
            dim = heads * hd
            qkv = torch.as_tensor(rng.integers(-127, 128, (n, t, 3 * dim), dtype=np.int8)).cuda()
            kw = dict(heads=heads, dim=dim, s_in=S_IN, s_out=S_OUT)
            want = qattention.qattention_plain(qkv, **kw)
            y_parent = torch.empty_like(want)
            qk, pv = qattention.scales(heads, dim, S_IN, S_OUT)

            def run_parent():
                return parent.tf2_qattention(qkv.data_ptr(), y_parent.data_ptr(), n, t, heads,
                                             hd, qk, pv, torch.cuda.current_stream().cuda_stream)

            parent_takes = run_parent() == 0
            torch.cuda.synchronize()
            fallbacks = torch.zeros(1, dtype=torch.int64, device="cuda")
            y = qattention.qattention(qkv, fallbacks=fallbacks, **kw)
            row = {"n": n, "t": t, "heads": heads, "hd": hd,
                   "mismatches": int((y != want).sum()),
                   "parent_mismatches": int((y_parent != want).sum()) if parent_takes else None,
                   "exact_division_share": int(fallbacks[0]) / (n * heads * t * t)}
            q, k, v = ((z.to(torch.float32) * S_IN).to(torch.bfloat16)
                       .reshape(n, t, heads, hd).transpose(1, 2).contiguous()
                       for z in torch.split(qkv, dim, dim=-1))
            # parent, this, this, parent
            theirs = [cuda_ms(run_parent, args.iters)] if parent_takes else []
            mine = [cuda_ms(lambda: qattention.qattention(qkv, **kw), args.iters)
                    for _ in range(2)]
            if parent_takes:
                theirs.append(cuda_ms(run_parent, args.iters))
            row.update(ms=mine, parent_ms=theirs or None,
                       plain_ms=cuda_ms(lambda: qattention.qattention_plain(qkv, **kw), 2),
                       sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                       args.iters))
            row["bytes_ms"], row["ops_ms"] = bound_ms(n, t, heads, dim)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
            del qkv, want, y_parent, q, k, v
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "s_in": S_IN, "s_out": S_OUT, "rows": rows}))
    return 1 if any(r["mismatches"] or r["parent_mismatches"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
