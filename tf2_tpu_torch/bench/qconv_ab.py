"""Times the conv kernels (``csrc/qconv.cu``) against another revision of
their source on one card, in one process:

    python -m tf2_tpu_torch.bench.qconv_ab --parent DIR

``DIR`` holds ``qconv.cu`` and ``qgemm.cuh`` of another revision (for the
parent commit: ``git show PARENT:tf2_tpu_torch/kernels/csrc/qconv.cu >
DIR/qconv.cu`` and the same for ``qgemm.cuh``), with the entry points'
first 19 arguments (``tf2_qconv_s1``, ``tf2_qconv_s2``, ``tf2_qconv_s2x1``);
they are built with nvcc into a temporary directory and never kept.

At every distinct conv shape the conv kernels see in ResNet-50 (default,
``phase_stem`` and ``optimize`` stems), GoogLeNet, SqueezeNet v1.1 and SSD
(256x256, 21 classes) at batch 64 and 1, both kernels run on the same
random int8 input of the real shape and random weights, are held against
``qconv_plain`` (0 mismatches), and are timed with CUDA events in the order
parent, this, this, parent, beside bf16 ``F.conv2d`` on the same operands
and the bound (``bench/conv_bound.py``, as ``chip_smoke.py`` counts it):
``ms`` back to back from the host (as ``chip_smoke.py`` times), and
``device_ms`` replayed from a CUDA graph (the kernel without the host's
launch overhead, which sets the time of the small b1 shapes).
Each row names the plan this revision took. Per model, batch and kernel
the times are summed over the forward (times the layers of that shape).
Prints one JSON line with the card's name and power limit; per-shape rows
go to stderr.
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

from tf2_tpu_torch.bench.conv_bound import bound_ms, conv_work
from tf2_tpu_torch.kernels import autotune, build, qconv

MODELS = [("resnet50", {}, {"block_fusion": False}),
          ("resnet50", {}, {"phase_stem": True, "block_fusion": False}),
          ("resnet50", {}, {"optimize": True, "block_fusion": False}), ("googlenet", {}, {}),
          ("squeezenet_v1_1", {}, {}), ("ssd", {"image": 256, "classes": 21}, {})]


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


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the kernels alone, without the host's launch
    overhead (``kernels.autotune.graph_ms``)."""
    return autotune.graph_ms(fn, iters)[0]


def conv_shapes(name: str, build_kw: dict, flags: dict) -> list[tuple]:
    """The conv-kernel calls of one Engine's graph at batch 1: (x shape,
    kshape, strides, pads, wfmt), one entry per node, the wpack2 stem as
    its packed stride-(2, 1) conv."""
    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized(name, seed=0, batch=1, **build_kw)
    eng = Engine(art.graph, art.params, device="cpu", **flags)
    shapes = activation_shapes(eng.graph, eng.params)
    out = []
    for node in eng.graph.nodes:
        if node.op != "qconv2d":
            continue
        a = node.attrs
        b, h, w, c = shapes[node.inputs[0]]
        if a["wfmt"] == "wpack2":
            lo, hi = a["pack_pad_w"]
            out.append(((b, h, (w + lo + hi) // 2, 2 * c), tuple(a["pack_kshape"]), (2, 1),
                        (tuple(a["pack_pad_h"]), (0, 0)), "int8"))
            continue
        kh, kw, _, _ = a["kshape"]
        strides = tuple(a.get("strides", (1, 1)))
        if (kh, kw) + strides == (1, 1, 1, 1):
            continue  # a GEMM (shift_matmul)
        padding = a.get("padding", "SAME")
        if not isinstance(padding, str):
            padding = [tuple(p) for p in padding]
        pads = qconv.resolve_pads(padding, kh, kw, *strides, h, w)
        out.append(((b, h, w, c), tuple(a["kshape"]), strides, pads, a["wfmt"]))
    return out


def build_parent(src: Path, out_dir: Path) -> ctypes.CDLL:
    lib_path = out_dir / "qconv_parent.so"
    for f in ("qconv.cu", "qgemm.cuh"):
        (out_dir / f).write_text((src / f).read_text())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "qconv.cu")], check=True, stdout=sys.stderr,
                   stderr=sys.stderr)
    return ctypes.CDLL(str(lib_path))


def operands(rng, x_shape, kshape, wfmt):
    kh, kw, cin, cout = kshape
    k = kh * kw * cin
    x = torch.as_tensor(rng.integers(-127, 128, x_shape, dtype=np.int8)).cuda()
    if wfmt == "pot4":
        from tf2_tpu_torch.transform import potq
        w = potq.pack_codes(rng.integers(0, 16, (k, cout)).astype(np.uint8))
    else:
        w = rng.integers(-127, 128, kshape, dtype=np.int8)
    es = (rng.uniform(0.5, 3.0, cout) / (64 * np.sqrt(k))).astype(np.float32)
    eb = rng.normal(0, 5, cout).astype(np.float32)
    return x, *(torch.as_tensor(a).cuda() for a in (w, es, eb))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qconv_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    rng = np.random.default_rng(0)
    rows, totals = [], {}
    calls = {}  # (x, kshape, strides, pads, wfmt, batch) -> {(model, option): count}
    for name, build_kw, flags in MODELS:
        label = name + "".join(f" {k}" for k in flags)
        for x1, kshape, strides, pads, wfmt in conv_shapes(name, build_kw, flags):
            for batch in (64, 1):
                key = ((batch, *x1[1:]), kshape, strides, pads, wfmt)
                per = calls.setdefault(key, {})
                per[label] = per.get(label, 0) + 1
    with tempfile.TemporaryDirectory() as d:
        parent = build_parent(args.parent, Path(d))
        for (x_shape, kshape, strides, pads, wfmt), per in calls.items():
            kernel = qconv.KERNELS[strides]
            pfn = getattr(parent, f"tf2_{kernel}")
            pfn.argtypes, pfn.restype = qconv._SIG[:19], ctypes.c_int
            x, w, es, eb = operands(rng, x_shape, kshape, wfmt)
            kw = dict(kshape=kshape, pads=pads, relu=True, wfmt=wfmt)
            want = qconv.qconv_plain(x, w, es, eb, strides=strides, **kw)
            y_parent = torch.empty_like(want)
            b, h, wd, c = x_shape
            kh, kwid, _, n = kshape
            (ph0, _), (pw0, _) = pads

            def run_parent():
                rc = pfn(x.data_ptr(), w.data_ptr(), es.data_ptr(), eb.data_ptr(),
                         y_parent.data_ptr(), b, h, wd, c, want.shape[1], want.shape[2], kh,
                         kwid, ph0, pw0, n, int(wfmt == "pot4"), 1,
                         torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"parent {kernel}: CUDA error {rc}")

            wrapper = getattr(qconv, kernel)

            def run_this():
                return wrapper(x, w, es, eb, **kw)

            run_parent()
            y = run_this()
            torch.cuda.synchronize()
            plan = qconv.launch_plan(x, w, strides=strides, kshape=kshape, pads=pads,
                                     wfmt=wfmt)
            theirs = [cuda_ms(run_parent, args.iters)]
            mine = [cuda_ms(run_this, args.iters) for _ in range(2)]
            theirs.append(cuda_ms(run_parent, args.iters))
            theirs_dev = [graph_ms(run_parent, args.iters)]
            mine_dev = [graph_ms(run_this, args.iters) for _ in range(2)]
            theirs_dev.append(graph_ms(run_parent, args.iters))
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = qconv.decode_hwio(w, wfmt, kshape).permute(3, 2, 0, 1).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            xbp = F.pad(xb, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
            bf16_ms = cuda_ms(lambda: F.conv2d(xbp, wb, stride=strides), args.iters)
            bytes_ms, ops_ms = bound_ms(*conv_work(x_shape, kshape, strides, pads, wfmt,
                                                   want.shape))
            row = {"kernel": kernel, "x": list(x_shape), "kshape": list(kshape),
                   "strides": list(strides), "pads": [list(p) for p in pads], "wfmt": wfmt,
                   "calls": per, "plan": plan.name, "grid": list(plan.grid),
                   "mismatches": int((y != want).sum()),
                   "parent_mismatches": int((y_parent != want).sum()),
                   "ms": mine, "parent_ms": theirs, "device_ms": mine_dev,
                   "parent_device_ms": theirs_dev, "bf16_conv2d_ms": bf16_ms,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
            for label, count in per.items():
                t = totals.setdefault(f"{label} b{x_shape[0]} {kernel}", {
                    "launches": 0, "ms": 0.0, "parent_ms": 0.0, "device_ms": 0.0,
                    "parent_device_ms": 0.0, "bf16_conv2d_ms": 0.0, "bound_ms": 0.0})
                t["launches"] += count
                t["ms"] += count * sum(mine) / 2
                t["parent_ms"] += count * sum(theirs) / 2
                t["device_ms"] += count * sum(mine_dev) / 2
                t["parent_device_ms"] += count * sum(theirs_dev) / 2
                t["bf16_conv2d_ms"] += count * bf16_ms
                t["bound_ms"] += count * max(bytes_ms, ops_ms)
            del x, w, es, eb, want, y, y_parent, xb, wb, xbp
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "per_forward": totals,
                      "mismatches": sum(r["mismatches"] for r in rows),
                      "parent_mismatches": sum(r["parent_mismatches"] for r in rows)}))
    return 1 if any(r["mismatches"] or r["parent_mismatches"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
