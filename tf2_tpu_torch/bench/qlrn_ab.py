"""Times the LRN kernel (``qlrn``, ``csrc/qlrn.cu``) against another revision
of it on one card, in one process:

    python -m tf2_tpu_torch.bench.qlrn_ab --parent DIR

``DIR`` holds ``qlrn.cu`` of another revision (and any header it includes)
whose ``tf2_qlrn`` takes (x, y, m, c, radius, s_in, s_out, alpha, bias,
beta_075, beta, stream) (for the parent commit: ``git show PARENT:
tf2_tpu_torch/kernels/csrc/qlrn.cu > DIR/qlrn.cu``); it is built with nvcc
into a temporary directory and never kept.

Shapes: GoogLeNet's two LRN nodes (``lrn_0`` on 64 channels, ``lrn_1`` on
192, both at 56x56, radius 2, beta 0.75) with their synthetic scales (the
CPU Engine's graph), at batch 64 and 1, on random int8 inputs. Each is held
against ``qlrn_plain`` (0 mismatches, both revisions), the elements this
revision's exact path took are counted, and each is timed in the order
parent, this, this, parent: ``ms`` back to back from the host, and
``device_ms`` replayed from a CUDA graph, beside the plain version,
``F.local_response_norm`` on the dequantized f32 tensor (NCHW view) and the
bound (each int8 input read once and each output written once over 3.35
TB/s). Prints one JSON line with the card's name and power limit and the
sums per forward; per-shape rows go to stderr.
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

from tf2_tpu_torch.bench.qconv_ab import cuda_ms, graph_ms
from tf2_tpu_torch.kernels import build, qlrn

H100_BYTES_PER_S = 3.35e12
_PARENT_SIG = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
               + [ctypes.c_int, ctypes.c_double, ctypes.c_void_p])


def lrn_nodes():
    """GoogLeNet's qlrn nodes of the CPU Engine's graph at batch 1, with
    their input shapes."""
    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("googlenet", seed=0, batch=1)
    eng = Engine(art.graph, art.params, device="cpu")
    shapes = activation_shapes(eng.graph, eng.params)
    return [(n, shapes[n.inputs[0]]) for n in eng.graph.nodes if n.op == "qlrn"]


def build_parent(src: Path, out_dir: Path) -> ctypes.CDLL:
    lib_path = out_dir / "qlrn_parent.so"
    for f in list(src.glob("*.cu")) + list(src.glob("*.cuh")):
        (out_dir / f.name).write_text(f.read_text())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "qlrn.cu")], check=True, stdout=sys.stderr, stderr=sys.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.tf2_qlrn.argtypes, lib.tf2_qlrn.restype = _PARENT_SIG, ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qlrn_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    rng = np.random.default_rng(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows, totals = [], {}
    with tempfile.TemporaryDirectory() as d:
        parent = build_parent(args.parent, Path(d))
        for node, shape in lrn_nodes():
            a = node.attrs
            kw = dict(radius=a.get("radius", 2), alpha=a.get("alpha", 1e-4),
                      beta=a.get("beta", 0.75), bias=a.get("bias", 1.0), s_in=a["s_in"],
                      s_out=a["s_out"])
            for batch in (64, 1):
                x = torch.as_tensor(rng.integers(-127, 128, (batch, *shape[1:]),
                                                 dtype=np.int8)).cuda()
                m, c = x.numel() // x.shape[-1], x.shape[-1]
                want = qlrn.qlrn_plain(x, **kw)
                y_parent = torch.empty_like(x)

                def run_parent():
                    rc = parent.tf2_qlrn(x.data_ptr(), y_parent.data_ptr(), m, c, kw["radius"],
                                         build.f32(kw["s_in"]), build.f32(kw["s_out"]),
                                         build.f32(kw["alpha"]), build.f32(kw["bias"]),
                                         int(abs(kw["beta"] - 0.75) < 1e-12),
                                         build.f32(kw["beta"]), stream())
                    if rc:
                        raise RuntimeError(f"parent qlrn: CUDA error {rc}")

                def run_this():
                    return qlrn.qlrn(x, **kw)

                slow = torch.zeros(1, dtype=torch.int32, device=x.device)
                y = qlrn.qlrn(x, slow_count=slow, **kw)
                run_parent()
                torch.cuda.synchronize()
                theirs = [cuda_ms(run_parent, args.iters)]
                mine = [cuda_ms(run_this, args.iters) for _ in range(2)]
                theirs.append(cuda_ms(run_parent, args.iters))
                theirs_dev = [graph_ms(run_parent, args.iters)]
                mine_dev = [graph_ms(run_this, args.iters) for _ in range(2)]
                theirs_dev.append(graph_ms(run_parent, args.iters))
                size = 2 * kw["radius"] + 1
                xf = (x.to(torch.float32) * kw["s_in"]).permute(0, 3, 1, 2)
                lib_ms = cuda_ms(lambda: F.local_response_norm(
                    xf, size, alpha=kw["alpha"] * size, beta=kw["beta"], k=kw["bias"]),
                    args.iters)
                row = {"node": node.name, "batch": batch, "m": m, "c": c,
                       "mismatches": int((y != want).sum()),
                       "parent_mismatches": int((y_parent != want).sum()),
                       "exact_path_elements": int(slow), "elements": m * c,
                       "ms": mine, "parent_ms": theirs, "device_ms": mine_dev,
                       "parent_device_ms": theirs_dev,
                       "plain_ms": cuda_ms(lambda: qlrn.qlrn_plain(x, **kw), 3),
                       "library_ms": lib_ms, "bound_ms": 2 * m * c / H100_BYTES_PER_S * 1e3}
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
                t = totals.setdefault(f"googlenet b{batch}", {
                    "launches": 0, "ms": 0.0, "parent_ms": 0.0, "device_ms": 0.0,
                    "parent_device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "bound_ms": 0.0})
                t["launches"] += 1
                for key in ("ms", "parent_ms", "device_ms", "parent_device_ms"):
                    t[key] += sum(row[key]) / 2
                for key in ("plain_ms", "library_ms", "bound_ms"):
                    t[key] += row[key]
    bad = sum(r["mismatches"] + r["parent_mismatches"] for r in rows)
    print(json.dumps({"card": card, "per_forward": totals, "mismatches": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
