"""Times the GEMM kernels against another revision of ``csrc/shift_matmul.cu``
on one card, in one process:

    python -m tf2_tpu_torch.bench.qgemm_ab --parent DIR           # qmatmul_int8
    python -m tf2_tpu_torch.bench.qgemm_ab --parent DIR --pot4    # qmatmul_pot4

``DIR`` holds ``shift_matmul.cu`` and the headers it includes of another
revision (for the parent commit: ``git show PARENT:tf2_tpu_torch/kernels/
csrc/F > DIR/F`` for ``shift_matmul.cu`` and each ``.cuh`` of ``csrc/``);
it is built with nvcc into a temporary directory and never kept.

The int8 mode (``qmatmul_int8``, ``csrc/qmm_int8.cuh``) takes a revision
whose ``tf2_qmatmul_int8`` takes (x, w (K, N), es, eb, r, y, m, n, k,
relu, radd, stream): one from before the weight was prepared K-major.
Shapes: ViT-B/16's dense layers (``vit_b16``, T = 196) at batch 64 and 1,
the residual layers with and without the residual; the fc of ResNet-50
(K 2048) and GoogLeNet (K 1024), SqueezeNet's int8 classifier (a 1x1 conv
on 13x13 pixels) and GoogLeNet's merged 1x1s (``merge_1x1``) at batch 64
and 1. On each, both kernels run on the same random int8 operands (this
revision on the weight prepared K-major, as the Engine holds it).

The pot4 mode (``qmatmul_pot4``, ``csrc/qmm_pot4.cuh``) takes a revision
whose ``tf2_qmatmul_pot4`` takes (x, w (K/2, N) packed codes, es, eb, y,
m, n, k, relu, stream): one from before the codes were prepared K-major.
Shapes: every pot4 GEMM node (1x1 stride-1 convs, dense layers) of
ResNet-50 (default and ``block_fusion``), GoogLeNet and SqueezeNet v1.1
(default and ``merge_1x1``) at batch 64 and 1, each distinct (M, K, N)
timed once, on random int8 inputs and random codes (this revision on the
codes prepared K-major, as the Engine holds them). Beside them: the
decode-at-load yardstick, the codes decoded to int8 once and prepared
K-major for ``qmatmul_int8`` as it is (twice the weight bytes; timed,
never routed).

Each shape is held against the plain version (0 mismatches) and timed in
the order parent, this, this, parent: ``ms`` back to back from the host,
and ``device_ms`` replayed from a CUDA graph (the kernel without the host's
launch overhead), beside ``torch._int_mm`` (no epilogue; on the decoded
weights in the pot4 mode; where it takes the shape: M > 16) and the bound
(bytes: every operand read once, the packed codes at half a byte a weight,
and the output written once over 3.35 TB/s; operations: 2 M N K over 1,979
TOP/s). Per group (model, option, batch) the times are summed over the
forward. Prints one JSON line with the card's name and power limit;
per-shape rows go to stderr.
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

from tf2_tpu_torch.bench.qconv_ab import cuda_ms, graph_ms
from tf2_tpu_torch.kernels import build, shift_matmul

H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12
_PARENT_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
_PARENT_POT4_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def vit_shapes(batch: int, tokens: int = 196) -> list[tuple]:
    """(group, M, K, N, residual, launches a forward) of vit_b16's dense
    layers; a residual layer also timed without its residual."""
    m = batch * tokens
    label = f"vit_b16 b{batch}"
    rows = [(label, m, 768, 768, False, 1),        # patch embedding
            (label, m, 768, 2304, False, 12),      # qkv
            (label, m, 768, 768, True, 12),        # proj + the residual
            (label, m, 768, 3072, False, 12),      # mlp1
            (label, m, 3072, 768, True, 12),       # mlp2 + the residual
            (label, batch, 768, 1000, False, 1)]   # head
    rows += [(f"{label} no residual", m, 768, 768, False, 12),
             (f"{label} no residual", m, 3072, 768, False, 12)]
    return rows


def merged_1x1_shapes(batch: int) -> list[tuple]:
    """GoogLeNet's merge_1x1 Engine's int8 GEMMs (the merged sibling 1x1s;
    the fc is a group of its own)."""
    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.kernels import dispatch
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("googlenet", seed=0, batch=1)
    eng = Engine(art.graph, art.params, device="cpu", merge_1x1=True)
    shapes = activation_shapes(eng.graph, eng.params)
    rows = []
    for n in eng.graph.nodes:
        if dispatch.runs_gemm(n, "int8") and n.op == "qconv2d":
            x = shapes[n.inputs[0]]
            rows.append((f"googlenet merge_1x1 b{batch}", batch * int(np.prod(x[1:-1])), x[-1],
                         n.attrs["kshape"][-1], False, 1))
    return rows


def all_shapes() -> list[tuple]:
    rows = []
    for batch in (64, 1):
        rows += vit_shapes(batch)
        rows += [(f"resnet50 fc b{batch}", batch, 2048, 1000, False, 1),
                 (f"googlenet fc b{batch}", batch, 1024, 1000, False, 1),
                 (f"squeezenet_v1_1 classifier b{batch}", batch * 169, 512, 1000, False, 1)]
        rows += merged_1x1_shapes(batch)
    return rows


def build_parent(src: Path, out_dir: Path) -> ctypes.CDLL:
    lib_path = out_dir / "shift_matmul_parent.so"
    for f in list(src.glob("*.cu")) + list(src.glob("*.cuh")):
        (out_dir / f.name).write_text(f.read_text())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "shift_matmul.cu")], check=True, stdout=sys.stderr,
                   stderr=sys.stderr)
    return ctypes.CDLL(str(lib_path))


def pot4_shapes() -> list[tuple]:
    """(group, M, K, N, launches a forward) of every distinct pot4 GEMM of
    the zoo's Engines at batch 64 and 1, from the CPU Engines' graphs."""
    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.kernels import dispatch
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    rows = []
    for name, options in [("resnet50", {"": {"block_fusion": False},
                                        " block_fusion": {"block_fusion": True}}),
                          ("googlenet", {"": {}, " merge_1x1": {"merge_1x1": True}}),
                          ("squeezenet_v1_1", {"": {}, " merge_1x1": {"merge_1x1": True}})]:
        art = synthetic_quantized(name, seed=0, batch=1)
        for label, flags in options.items():
            eng = Engine(art.graph, art.params, device="cpu", **flags)
            shapes = activation_shapes(eng.graph, eng.params)
            counts: dict[tuple, int] = {}
            for n in eng.graph.nodes:
                if dispatch.runs_gemm(n, "pot4"):
                    x = shapes[n.inputs[0]]
                    key = (int(np.prod(x[:-1])), x[-1], n.attrs["kshape"][-1])
                    counts[key] = counts.get(key, 0) + 1
            for batch in (64, 1):
                rows += [(f"{name}{label} b{batch}", batch * m, k, n, c)
                         for (m, k, n), c in counts.items()]
    return rows


def bound_ms(m: int, k: int, n: int, residual: bool, pot4: bool = False) -> tuple[float, float]:
    nbytes = m * k + k * n // (2 if pot4 else 1) + 8 * n + m * n * (2 if residual else 1)
    return nbytes / H100_BYTES_PER_S * 1e3, 2.0 * m * n * k / H100_INT8_OPS_PER_S * 1e3


def int_mm_ms(x, w, iters: int) -> float | None:
    """torch._int_mm's time on these operands, or None where cuBLAS refuses
    them (it refuses some shapes that its own checks let through)."""
    try:
        return cuda_ms(lambda: torch._int_mm(x, w), iters)
    except RuntimeError:
        return None


def main_pot4(args, card: str) -> int:
    from tf2_tpu_torch.transform import potq

    rng = np.random.default_rng(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    shapes = pot4_shapes()
    timed: dict[tuple, dict] = {}
    with tempfile.TemporaryDirectory() as d:
        parent = build_parent(args.parent, Path(d))
        parent.tf2_qmatmul_pot4.argtypes = _PARENT_POT4_SIG
        parent.tf2_qmatmul_pot4.restype = ctypes.c_int
        for m, k, n in sorted({s[1:4] for s in shapes}):
            x = torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
            codes = rng.integers(0, 16, (k, n)).astype(np.uint8)
            wp = torch.as_tensor(potq.pack_codes(codes)).cuda()
            w8 = torch.as_tensor(potq.pot_decode_np(codes)).cuda()
            es = torch.as_tensor((rng.uniform(0.5, 3.0, n) / (64 * np.sqrt(k)))
                                 .astype(np.float32)).cuda()
            eb = torch.as_tensor(rng.normal(0, 5, n).astype(np.float32)).cuda()
            wk, w8k = shift_matmul.prepare_weight(wp), shift_matmul.prepare_weight(w8)
            want = shift_matmul.qmatmul_pot4_plain(x, wp, es, eb, True)
            y_parent = torch.empty_like(want)

            def run_parent():
                rc = parent.tf2_qmatmul_pot4(x.data_ptr(), wp.data_ptr(), es.data_ptr(),
                                             eb.data_ptr(), y_parent.data_ptr(), m, n, k, 1,
                                             stream())
                if rc:
                    raise RuntimeError(f"parent qmatmul_pot4: CUDA error {rc}")

            def run_this():
                return shift_matmul.qmatmul_pot4(x, wk, es, eb, True)

            def run_int8():
                return shift_matmul.qmatmul_int8(x, w8k, es, eb, True)

            run_parent()
            y, y8 = run_this(), run_int8()
            torch.cuda.synchronize()
            theirs = [cuda_ms(run_parent, args.iters)]
            mine = [cuda_ms(run_this, args.iters) for _ in range(2)]
            theirs.append(cuda_ms(run_parent, args.iters))
            theirs_dev = [graph_ms(run_parent, args.iters)]
            mine_dev = [graph_ms(run_this, args.iters) for _ in range(2)]
            theirs_dev.append(graph_ms(run_parent, args.iters))
            takes = m > 16 and k % 8 == 0 and n % 8 == 0  # torch._int_mm's shapes
            bytes_ms, ops_ms = bound_ms(m, k, n, False, pot4=True)
            row = {"m": m, "k": k, "n": n,
                   "plan": shift_matmul.launch_plan_pot4(x, n).name,
                   "mismatches": int((y != want).sum()),
                   "parent_mismatches": int((y_parent != want).sum()),
                   "int8_mismatches": int((y8 != want).sum()),
                   "ms": mine, "parent_ms": theirs, "device_ms": mine_dev,
                   "parent_device_ms": theirs_dev,
                   "int8_ms": cuda_ms(run_int8, args.iters),
                   "int8_device_ms": graph_ms(run_int8, args.iters),
                   "int_mm_ms": int_mm_ms(x, w8, args.iters) if takes else None,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            timed[(m, k, n)] = row
            print(json.dumps(row), file=sys.stderr, flush=True)
            del x, wp, w8, wk, w8k, es, eb, want, y, y8, y_parent
            torch.cuda.empty_cache()
    totals = {}
    for group, m, k, n, count in shapes:
        r = timed[(m, k, n)]
        t = totals.setdefault(group, {"launches": 0, "ms": 0.0, "parent_ms": 0.0,
                                      "device_ms": 0.0, "parent_device_ms": 0.0,
                                      "int8_ms": 0.0, "int8_device_ms": 0.0,
                                      "int_mm_ms": 0.0, "bound_ms": 0.0})
        t["launches"] += count
        for key in ("ms", "parent_ms", "device_ms", "parent_device_ms"):
            t[key] += count * sum(r[key]) / 2
        t["int8_ms"] += count * r["int8_ms"]
        t["int8_device_ms"] += count * r["int8_device_ms"]
        t["int_mm_ms"] = None if r["int_mm_ms"] is None or t["int_mm_ms"] is None else \
            t["int_mm_ms"] + count * r["int_mm_ms"]
        t["bound_ms"] += count * max(r["bytes_ms"], r["ops_ms"])
    bad = sum(r["mismatches"] + r["parent_mismatches"] + r["int8_mismatches"]
              for r in timed.values())
    print(json.dumps({"card": card, "per_forward": totals, "mismatches": bad}))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pot4", action="store_true", help="time qmatmul_pot4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qgemm_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    if args.pot4:
        return main_pot4(args, card)
    rng = np.random.default_rng(0)
    rows, totals = [], {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory() as d:
        parent = build_parent(args.parent, Path(d))
        parent.tf2_qmatmul_int8.argtypes = _PARENT_SIG
        parent.tf2_qmatmul_int8.restype = ctypes.c_int
        for group, m, k, n, resid, count in all_shapes():
            x = torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
            w = torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8)).cuda()
            es = torch.as_tensor((rng.uniform(0.5, 3.0, n) / (127 * np.sqrt(k)))
                                 .astype(np.float32)).cuda()
            eb = torch.as_tensor(rng.normal(0, 5, n).astype(np.float32)).cuda()
            residual = None
            if resid:
                residual = (torch.as_tensor(rng.integers(-127, 128, (m, n), dtype=np.int8))
                            .cuda(), 0.61)
            wp = shift_matmul.prepare_weight(w)
            want = shift_matmul.qmatmul_int8_plain(x, w, es, eb, True, residual)
            y_parent = torch.empty_like(want)
            r_ptr, radd = (None, 0.0) if residual is None else (residual[0].data_ptr(), 0.61)

            def run_parent():
                rc = parent.tf2_qmatmul_int8(x.data_ptr(), w.data_ptr(), es.data_ptr(),
                                             eb.data_ptr(), r_ptr, y_parent.data_ptr(), m, n,
                                             k, 1, build.f32(radd), stream())
                if rc:
                    raise RuntimeError(f"parent qmatmul_int8: CUDA error {rc}")

            def run_this():
                return shift_matmul.qmatmul_int8(x, wp, es, eb, True, residual)

            run_parent()
            y = run_this()
            torch.cuda.synchronize()
            plan = shift_matmul.launch_plan(x, n, residual)
            theirs = [cuda_ms(run_parent, args.iters)]
            mine = [cuda_ms(run_this, args.iters) for _ in range(2)]
            theirs.append(cuda_ms(run_parent, args.iters))
            theirs_dev = [graph_ms(run_parent, args.iters)]
            mine_dev = [graph_ms(run_this, args.iters) for _ in range(2)]
            theirs_dev.append(graph_ms(run_parent, args.iters))
            takes = m > 16 and k % 8 == 0 and n % 8 == 0  # torch._int_mm's shapes
            lib_ms = cuda_ms(lambda: torch._int_mm(x, w), args.iters) if takes else None
            bytes_ms, ops_ms = bound_ms(m, k, n, resid)
            row = {"group": group, "m": m, "k": k, "n": n, "residual": resid, "count": count,
                   "plan": plan.name, "grid": list(plan.grid),
                   "mismatches": int((y != want).sum()),
                   "parent_mismatches": int((y_parent != want).sum()),
                   "ms": mine, "parent_ms": theirs, "device_ms": mine_dev,
                   "parent_device_ms": theirs_dev, "int_mm_ms": lib_ms,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
            t = totals.setdefault(group, {"launches": 0, "ms": 0.0, "parent_ms": 0.0,
                                          "device_ms": 0.0, "parent_device_ms": 0.0,
                                          "int_mm_ms": 0.0, "bound_ms": 0.0})
            t["launches"] += count
            t["ms"] += count * sum(mine) / 2
            t["parent_ms"] += count * sum(theirs) / 2
            t["device_ms"] += count * sum(mine_dev) / 2
            t["parent_device_ms"] += count * sum(theirs_dev) / 2
            t["int_mm_ms"] = None if lib_ms is None or t["int_mm_ms"] is None else \
                t["int_mm_ms"] + count * lib_ms
            t["bound_ms"] += count * max(bytes_ms, ops_ms)
            del x, w, wp, es, eb, residual, want, y, y_parent
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "per_forward": totals,
                      "mismatches": sum(r["mismatches"] for r in rows),
                      "parent_mismatches": sum(r["parent_mismatches"] for r in rows)}))
    return 1 if any(r["mismatches"] or r["parent_mismatches"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
