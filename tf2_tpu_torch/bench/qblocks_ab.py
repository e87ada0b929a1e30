"""Times the chain kernel (``qblockchain``, ``csrc/qblocks.cu``) against
another revision of its source on one card, in one process:

    python -m tf2_tpu_torch.bench.qblocks_ab --parent DIR

``DIR`` holds ``qblocks.cu`` and ``qgemm.cuh`` of another revision whose
``tf2_qblock`` takes (x, w1, es1, eb1, w2, es2, eb2, w3, es3, eb3, wd, esd,
ebd, y, b, h, w, cin, cm, cout, down, relu, saso, sbso, rows, stream), the
weights in the reference's layout and ``rows`` output rows a CTA (for the
parent commit: ``git show PARENT:tf2_tpu_torch/kernels/csrc/qblocks.cu >
DIR/qblocks.cu`` and the same for ``qgemm.cuh``); it is built with nvcc
into a temporary directory and never kept, and launched with that
revision's band height (``parent_band_rows``).

Each of ResNet-50's four fused chains (``block_fusion=True``: stage 1's
three blocks, the first with the downsample, stage 2's three, stage 3's
five, stage 4's two) at batch 64 and 1, on random int8 weights and input
of the real shapes, both revisions are held against
``qblockchain_plain`` (0 mismatches) and timed in the order parent, this,
this, parent: ``ms`` back to back from the host, ``device_ms`` replayed
from a CUDA graph, beside the bound (``chip_smoke.py``'s count: the input
read once, the output written once, every weight, es and eb read once; 2
operations a multiply-accumulate of each 1x1, downsample and 3x3 tap
inside the image, over 1,979 TOP/s). Each row names the plan of each
block. ``--plans`` also times every other plan the kernel takes for each
block shape (the cost model's candidates), one block at a time. Prints one
JSON line with the card's name and power limit; per-chain rows go to
stderr.
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

from tf2_tpu_torch.bench.conv_bound import bound_ms, taps
from tf2_tpu_torch.bench.qconv_ab import cuda_ms, graph_ms
from tf2_tpu_torch.kernels import build, qblocks, shift_matmul

# (name, h, [(cin, cm, cout, down), ...]): ResNet-50's fused chains
CHAINS = [("stage1", 56, [(64, 64, 256, True), (256, 64, 256, False), (256, 64, 256, False)]),
          ("stage2", 28, [(512, 128, 512, False)] * 3),
          ("stage3", 14, [(1024, 256, 1024, False)] * 5),
          ("stage4", 7, [(2048, 512, 2048, False)] * 2)]
_PARENT_SIG = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
               + [ctypes.c_int, ctypes.c_void_p])


def parent_band_rows(b: int, h: int, w: int, cm: int, sms: int) -> int:
    """The previous chain kernel's band height (its ``band_rows``): the
    most rows, up to 8, whose shared memory fits and that still give two
    CTAs an SM, else 1."""
    ps = -(-cm // 32) * 32 + 16

    def smem(r):
        return (r + 2) * (w + 2) * ps + r * w * ps + 2 * 64 * 80

    fits = [r for r in range(1, min(8, h) + 1) if smem(r) <= qblocks.SMEM_LIMIT]
    full = [r for r in fits if b * -(-h // r) >= 2 * sms]
    return max(full) if full else 1


def make_chain(rng, blocks, dev):
    out = []
    for cin, cm, cout, down in blocks:
        convs = [("1", (cin, cm), cin), ("2", (3, 3, cm, cm), 9 * cm), ("3", (cm, cout), cm)]
        if down:
            convs.append(("d", (cin, cout), cin))
        blk = {"sa_over_so": float(rng.uniform(0.5, 1.5)),
               "sb_over_so": float(rng.uniform(0.5, 1.5)), "relu": True}
        for key, shape, k in convs:
            n = shape[-1]
            blk["w" + key] = torch.as_tensor(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
            blk["es" + key] = torch.as_tensor((rng.uniform(0.5, 2.0, n) * 40
                                               / (127 * 127 * np.sqrt(k))).astype(np.float32)).to(dev)
            blk["eb" + key] = torch.as_tensor(rng.normal(0, 3, n).astype(np.float32)).to(dev)
        out.append(blk)
    return out


def prepared(blocks):
    out = []
    for blk in blocks:
        p = dict(blk)
        for k in ("w1", "w3", "wd"):
            if k in p:
                p[k] = shift_matmul.prepare_weight(p[k])
        p["w2"] = qblocks.prepare_w2(p["w2"])
        out.append(p)
    return out


def chain_bound_ms(b, h, blocks):
    _, t = taps(h, 3, 1, 1, h)
    macs, wbytes = 0, 0
    for cin, cm, cout, down in blocks:
        macs += b * h * h * (cin * cm + cm * cout + (cin * cout if down else 0))
        macs += b * t * t * cm * cm
        wbytes += cin * cm + 9 * cm * cm + cm * cout + (cin * cout if down else 0)
        wbytes += 8 * (2 * cm + cout + (cout if down else 0))
    nbytes = b * h * h * (blocks[0][0] + blocks[-1][2]) + wbytes
    return bound_ms(nbytes, 2.0 * macs)


def build_parent(src: Path, out_dir: Path) -> ctypes.CDLL:
    lib_path = out_dir / "qblocks_parent.so"
    for f in ("qblocks.cu", "qgemm.cuh"):
        (out_dir / f).write_text((src / f).read_text())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "qblocks.cu")], check=True, stdout=sys.stderr,
                   stderr=sys.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.tf2_qblock.argtypes, lib.tf2_qblock.restype = _PARENT_SIG, ctypes.c_int
    return lib


def parent_chain(lib, x, blocks, sms):
    """The chain through the other revision's kernel, one launch a block,
    ping-ponging between two buffers as its wrapper did."""
    b, h, w, cin = x.shape
    widest = max(blk["w3"].shape[1] for blk in blocks)
    bufs = [torch.empty(b * h * w * widest, dtype=torch.int8, device=x.device)
            for _ in range(2)]

    def run():
        xi, ci = x, cin
        for i, blk in enumerate(blocks):
            cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
            y = bufs[i % 2][:b * h * w * cout].view(b, h, w, cout)
            down = "wd" in blk
            rc = lib.tf2_qblock(
                xi.data_ptr(), blk["w1"].data_ptr(), blk["es1"].data_ptr(),
                blk["eb1"].data_ptr(), blk["w2"].data_ptr(), blk["es2"].data_ptr(),
                blk["eb2"].data_ptr(), blk["w3"].data_ptr(), blk["es3"].data_ptr(),
                blk["eb3"].data_ptr(), blk["wd"].data_ptr() if down else None,
                blk["esd"].data_ptr() if down else None, blk["ebd"].data_ptr() if down else None,
                y.data_ptr(), b, h, w, ci, cm, cout, int(down), 1,
                build.f32(blk["sa_over_so"]), build.f32(blk["sb_over_so"]),
                parent_band_rows(b, h, w, cm, sms), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent qblock: CUDA error {rc}")
            xi, ci = y, cout
        return xi

    return run


def time_plans(rng, b, h, spec, dev, iters):
    """Every candidate plan of one block, timed alone (CUDA graph)."""
    cin, cm, cout, down = spec
    blocks = make_chain(rng, [spec], dev)
    pb = prepared(blocks)
    x = torch.as_tensor(rng.integers(-127, 128, (b, h, h, cin), dtype=np.int8)).to(dev)
    want = qblocks.qblockchain_plain(x, blocks)
    rows = []
    for g, r, wc, c, bn in qblocks._candidates(b, h, h, cm, cout, 16):
        p = qblocks.make_plan(b, h, h, cm, g, r, wc, c, bn)
        if p.smem > qblocks.SMEM_LIMIT:
            continue
        saved = qblocks.launch_plan
        qblocks.launch_plan = lambda *a, p=p: p
        try:
            ok = torch.equal(qblocks.qblockchain(x, pb), want)
            ms = graph_ms(lambda: qblocks.qblockchain(x, pb), iters)
        except RuntimeError as e:  # a cluster shape the card cannot hold
            ok, ms = str(e), None
        finally:
            qblocks.launch_plan = saved
        est = qblocks._cost(b, h, h, cin, cm, cout, down, g, r, wc, c, bn, p.smem, 132)
        rows.append({"plan": p.name, "ctas": p.ctas, "smem": p.smem, "device_ms": ms,
                     "model_ms": est * 1e3, "equal": ok})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qblocks_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    rows, totals, plan_rows = [], {}, []
    with tempfile.TemporaryDirectory() as d:
        parent = build_parent(args.parent, Path(d))
        for batch in (64, 1):
            for name, h, spec in CHAINS:
                blocks = make_chain(rng, spec, dev)
                pb = prepared(blocks)
                x = torch.as_tensor(rng.integers(-127, 128, (batch, h, h, spec[0][0]),
                                                 dtype=np.int8)).to(dev)
                want = qblocks.qblockchain_plain(x, blocks)
                run_parent = parent_chain(parent, x, blocks, sms)

                def run_this():
                    return qblocks.qblockchain(x, pb)

                y_parent = run_parent().clone()
                y = run_this()
                torch.cuda.synchronize()
                theirs = [cuda_ms(run_parent, args.iters)]
                mine = [cuda_ms(run_this, args.iters) for _ in range(2)]
                theirs.append(cuda_ms(run_parent, args.iters))
                theirs_dev = [graph_ms(run_parent, args.iters)]
                mine_dev = [graph_ms(run_this, args.iters) for _ in range(2)]
                theirs_dev.append(graph_ms(run_parent, args.iters))
                bytes_ms, ops_ms = chain_bound_ms(batch, h, spec)
                plans = [qblocks.launch_plan(batch, h, h, ci, cm, co, dn, dev).name
                         for ci, cm, co, dn in spec]
                row = {"chain": name, "batch": batch, "blocks": len(spec), "plans": plans,
                       "mismatches": int((y != want).sum()),
                       "parent_mismatches": int((y_parent != want).sum()),
                       "parent_rows": parent_band_rows(batch, h, h, spec[0][1], sms),
                       "ms": mine, "parent_ms": theirs, "device_ms": mine_dev,
                       "parent_device_ms": theirs_dev, "bytes_ms": bytes_ms, "ops_ms": ops_ms}
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
                t = totals.setdefault(f"b{batch}", {"ms": 0.0, "parent_ms": 0.0,
                                                    "device_ms": 0.0, "parent_device_ms": 0.0,
                                                    "bound_ms": 0.0})
                t["ms"] += sum(mine) / 2
                t["parent_ms"] += sum(theirs) / 2
                t["device_ms"] += sum(mine_dev) / 2
                t["parent_device_ms"] += sum(theirs_dev) / 2
                t["bound_ms"] += max(bytes_ms, ops_ms)
                if args.plans:
                    for spec_i in dict.fromkeys(spec):
                        for r in time_plans(rng, batch, h, spec_i, dev, args.iters):
                            r.update(chain=name, batch=batch, block=list(spec_i))
                            plan_rows.append(r)
                            print(json.dumps(r), file=sys.stderr, flush=True)
                del x, want, y, y_parent, blocks, pb
                torch.cuda.empty_cache()
    print(json.dumps({"card": card, "per_forward": totals,
                      "mismatches": sum(r["mismatches"] for r in rows),
                      "parent_mismatches": sum(r["parent_mismatches"] for r in rows),
                      "plans_unequal": sum(r["equal"] is not True for r in plan_rows)}))
    return 1 if any(r["mismatches"] or r["parent_mismatches"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
