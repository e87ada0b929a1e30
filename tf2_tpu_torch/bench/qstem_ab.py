"""Times the stem kernel (``qstem``, ``csrc/qstem.cu``) against another
revision of it and against the other stem routes on one card, in one
process:

    python -m tf2_tpu_torch.bench.qstem_ab [--parent DIR] [--plans]

``DIR`` holds another revision's tree (for the parent commit: ``git archive
PARENT | tar -x -C DIR``); its package is loaded beside this one under
another name (``wrapper_ab.load_package``) and its ``qstem.qstem`` is
called on ``fold_weight``'s matrix, its kernels built in its own tree.

Stems: the zoo's three (ResNet-50's and GoogLeNet's 7x7 SAME 3 -> 64 at
224x224, SqueezeNet v1.1's 3x3 VALID 3 -> 64 at 224x224, SSD's 3x3 SAME
3 -> 32 at 256x256), relu on, s_in 0.02, seeded random weights, es, eb
and f32 images, at batch 64 and 1. Each route is held against
``qstem_plain`` (0 mismatches) and timed from a CUDA graph (``device_ms``)
and host-launched (``ms``): this revision's kernel on its prepared weight
(the Engine's stem node) and the parent's, in the order parent, this,
this, parent; the two-pass route of a stem the kernel does not take,
quantize + ``qconv_s2`` (``node_conv_s2``), and ``qconv_s2`` alone; bf16 ``F.conv2d``; the bound
(the f32 image and the weight read once, the int8 output written once,
over 3.35 TB/s). With ``--plans``, every step (1, 2 or 4 rows, copies 1 or
2 steps ahead) of this kernel's plan at batch 64, timed the same way.
Prints one JSON line with the card's name and power limit; per-shape rows
go to stderr.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tf2_tpu_torch.bench.qconv_ab import cuda_ms, graph_ms
from tf2_tpu_torch.kernels import build, dispatch, qconv, qstem

H100_BYTES_PER_S = 3.35e12
STEMS = {"resnet50": (224, 3, 64, 7, "SAME"), "squeezenet_v1_1": (224, 3, 64, 3, "VALID"),
         "ssd": (256, 3, 32, 3, "SAME")}
S_IN = 0.02


def stem_case(b: int, image: int, cin: int, cout: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed + k + b)
    x = torch.as_tensor(rng.standard_normal((b, image, image, cin), dtype=np.float32)).cuda()
    w = torch.as_tensor(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).cuda()
    es = torch.as_tensor((rng.uniform(0.5, 4.0, cout) / (127 * np.sqrt(k * k * cin)))
                         .astype(np.float32)).cuda()
    eb = torch.as_tensor(rng.normal(0, 20, cout).astype(np.float32)).cuda()
    return x, w, es, eb


def with_plan(p, fn):
    """``fn`` launched on plan ``p`` (the wrapper's plan replaced for the
    call, its cached launches dropped before and after)."""
    def call():
        chosen = qstem.plan
        qstem.plan = lambda *a, **kw: p
        qstem._STEM_LAUNCHES.clear()
        try:
            return fn()
        finally:
            qstem.plan = chosen
            qstem._STEM_LAUNCHES.clear()
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qstem_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    parent = None
    if args.parent:
        from tf2_tpu_torch.bench.wrapper_ab import load_package

        load_package(args.parent.resolve(), "tf2_tpu_torch_parent")
        import importlib

        parent = importlib.import_module("tf2_tpu_torch_parent.kernels.qstem")
    out = {"card": card, "iters": args.iters, "rows": {}, "mismatches": 0}
    for name, (image, cin, cout, k, padding) in STEMS.items():
        for b in (64, 1):
            x, w, es, eb = stem_case(b, image, cin, cout, k)
            wp = qstem.prepare_weight(w)
            wmat = qstem.fold_weight(w)
            kw = dict(padding=padding, relu=True, scale=S_IN)
            want = qstem.qstem_plain(x, wmat, es, eb, kh=k, kw=k, **kw)
            pads = qconv.resolve_pads(padding, k, k, 2, 2, image, image)
            conv_kw = dict(kshape=(k, k, cin, cout), pads=pads, relu=True, wfmt="int8")
            x_q = dispatch.quantize(x, S_IN)
            routes = {"this": lambda: qstem.fused_qstem(x, wp, es, eb, **kw),
                      "node_conv_s2": lambda: qconv.qconv_s2(dispatch.quantize(x, S_IN), w, es,
                                                             eb, **conv_kw),
                      "conv_s2": lambda: qconv.qconv_s2(x_q, w, es, eb, **conv_kw)}
            if parent is not None:
                routes["parent"] = lambda: parent.qstem(x, wmat, es, eb, kh=k, kw=k, **kw)
            for label, fn in routes.items():
                bad = int((fn() != want).sum())
                out["mismatches"] += bad
                if bad:
                    print(f"{name} b{b} {label}: {bad} mismatches", file=sys.stderr)
            n = args.iters if b == 64 else 5 * args.iters
            row = {"plan": qstem.plan(b, image, image, cin, cout, k, padding).name}
            order = ["parent", "this", "this", "parent"] if parent else ["this"]
            times: dict[str, list] = {}
            for label in order:
                times.setdefault(label, []).append((graph_ms(routes[label], n),
                                                    cuda_ms(routes[label], n)))
            for label in ("node_conv_s2", "conv_s2"):
                times[label] = [(graph_ms(routes[label], n), cuda_ms(routes[label], n))]
            for label, t in times.items():
                row[label] = {"device_ms": float(np.median([d for d, _ in t])),
                              "ms": float(np.median([h for _, h in t]))}
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            pad = k // 2 if padding == "SAME" else 0
            conv = lambda: F.conv2d(xb, wb, stride=2, padding=pad)  # noqa: E731
            row["bf16_conv2d"] = {"device_ms": graph_ms(conv, n), "ms": cuda_ms(conv, n)}
            row["bound_ms"] = (x.numel() * 4 + w.numel() + 8 * cout + want.numel()) \
                / H100_BYTES_PER_S * 1e3
            if args.plans and b == 64:
                row["plans"] = {}
                for rs in (1, 2, 4):
                    for depth in (1, 2):
                        p = qstem.plan(b, image, image, cin, cout, k, padding, rs=rs, depth=depth)
                        fn = with_plan(p, routes["this"])
                        bad = int((fn() != want).sum())
                        out["mismatches"] += bad
                        row["plans"][p.name] = {"device_ms": graph_ms(fn, n), "mismatches": bad}
            out["rows"][f"{name} b{b}"] = row
            print(f"{name} b{b}: {json.dumps(row)}", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0 if out["mismatches"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
