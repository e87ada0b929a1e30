"""Times the int8 GEMM (``csrc/qmm_int8.cuh``) and the chain kernel
(``csrc/qblocks.cu``) rebuilt at other ring shapes than the ones they ship
with, on one card, in one process:

    python -m tf2_tpu_torch.bench.ring_variants

The GEMM is rebuilt (nvcc, into a temporary directory) with each (most
ring slots, 64-deep sub-tiles a slot) of GEMM_VARIANTS and runs ViT-B/16's four
large dense shapes at batch 64 (qkv, proj with the residual, mlp1, mlp2
with the residual) on the tiles 128x128 and 128x64; the chain kernel with
each ring depth of CHAIN_VARIANTS runs one block of each of ResNet-50's
four chains at batch 64 on the plan the wrapper picks. Every build, the
shipped one first, runs the same random operands: 0 mismatches against the
plain versions required, device times from a CUDA graph. Prints one JSON
line with the card's name and power limit; rows go to stderr.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from tf2_tpu_torch.bench.qblocks_ab import CHAINS, make_chain, prepared
from tf2_tpu_torch.bench.qconv_ab import graph_ms
from tf2_tpu_torch.kernels import build, qblocks, shift_matmul

GEMM_VARIANTS = [(6, 1), (4, 1), (3, 1), (6, 2)]   # (MAX_STAGES, KSUB)
CHAIN_VARIANTS = [4, 3, 6]                         # STAGES
GEMM_SHAPES = [(12544, 768, 2304, False), (12544, 768, 768, True), (12544, 768, 3072, False),
               (12544, 3072, 768, True)]


def _sub(src: str, name: str, value: int) -> str:
    pat = rf"constexpr int {name} = \d+;"
    if not re.search(pat, src):
        raise RuntimeError(f"the source no longer declares {name} as expected")
    return re.sub(pat, f"constexpr int {name} = {value};", src, count=1)


def _build(kind: str, consts: dict, out: Path) -> ctypes.CDLL:
    for f in build.CSRC.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    if kind == "gemm":
        hdr = (build.CSRC / "qmm_int8.cuh").read_text()
        for k, v in consts.items():
            hdr = _sub(hdr, k, v)
        (out / "qmm_int8.cuh").write_text(hdr)
        src = "shift_matmul.cu"
        (out / src).write_text((build.CSRC / src).read_text())
    else:
        src = "qblocks.cu"
        text = (build.CSRC / src).read_text()
        for k, v in consts.items():
            text = _sub(text, k, v)
        (out / src).write_text(text)
    lib = out / "lib.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out / src)],
                   check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))
    if kind == "gemm":
        cdll.tf2_qmatmul_int8.argtypes = shift_matmul._SIG_INT8
        cdll.tf2_qmatmul_int8.restype = ctypes.c_int
    else:
        cdll.tf2_qblock.argtypes = qblocks._SIG
        cdll.tf2_qblock.restype = ctypes.c_int
    return cdll


def _gemm_rows(libs, rng):
    rows, failed = [], False
    for m, k, n, resid in GEMM_SHAPES:
        x = torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        w = torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8)).cuda()
        es = torch.as_tensor((rng.uniform(0.5, 3.0, n) / (127 * np.sqrt(k))).astype(np.float32)).cuda()
        eb = torch.as_tensor(rng.normal(0, 5, n).astype(np.float32)).cuda()
        r = torch.as_tensor(rng.integers(-127, 128, (m, n), dtype=np.int8)).cuda() if resid else None
        wp = shift_matmul.prepare_weight(w)
        want = shift_matmul.qmatmul_int8_plain(x, w, es, eb, True, None if r is None else (r, 0.61))
        y = torch.empty_like(want)
        for name, lib in libs:
            for tile in (0, 1):
                def run():
                    rc = lib.tf2_qmatmul_int8(
                        x.data_ptr(), wp.data_ptr(), wp.stride(1), es.data_ptr(), eb.data_ptr(),
                        None if r is None else r.data_ptr(), y.data_ptr(), m, n, k, 1,
                        build.f32(0.61), tile, 16, 16, None, None, 1,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"CUDA error {rc}")
                try:
                    ms = graph_ms(run, 20)
                    bad = int((y != want).sum())
                except RuntimeError as e:
                    ms, bad = None, str(e)
                failed |= isinstance(bad, int) and bad > 0  # a launch refused is recorded
                row = {"kernel": "qmatmul_int8", "variant": name, "tile": tile, "m": m, "k": k,
                       "n": n, "residual": resid, "device_ms": ms, "mismatches": bad}
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
    return rows, failed


def _chain_rows(libs, rng):
    rows, failed = [], False
    dev = torch.device("cuda", torch.cuda.current_device())
    for name, h, spec in CHAINS:
        cin, cm, cout, down = spec[-1]
        blocks = make_chain(rng, [spec[-1]], dev)
        blk = prepared(blocks)[0]
        x = torch.as_tensor(rng.integers(-127, 128, (64, h, h, cin), dtype=np.int8)).to(dev)
        want = qblocks.qblockchain_plain(x, blocks)
        y = torch.empty_like(want)
        p = qblocks.launch_plan(64, h, h, cin, cm, cout, down, dev)
        for vname, lib in libs:
            def run():
                rc = lib.tf2_qblock(
                    x.data_ptr(), cin, blk["w1"].data_ptr(), blk["w1"].stride(1),
                    blk["es1"].data_ptr(), blk["eb1"].data_ptr(), blk["w2"].data_ptr(),
                    blk["w2"].stride(3), blk["es2"].data_ptr(), blk["eb2"].data_ptr(),
                    blk["w3"].data_ptr(), blk["w3"].stride(1), blk["es3"].data_ptr(),
                    blk["eb3"].data_ptr(), None, 16, None, None, y.data_ptr(), cout,
                    64, h, h, cin, cm, cout, 0, 1, build.f32(blk["sa_over_so"]),
                    build.f32(blk["sb_over_so"]), p.g, p.r, p.wc, p.c, p.bn,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            try:
                ms = graph_ms(run, 20)
                bad = int((y != want).sum())
            except RuntimeError as e:
                ms, bad = None, str(e)
            failed |= isinstance(bad, int) and bad > 0
            row = {"kernel": "qblockchain", "variant": vname, "chain": name, "plan": p.name,
                   "device_ms": ms, "mismatches": bad}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    return rows, failed


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ring_variants: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    jobs = [("gemm", {"MAX_STAGES": s, "KSUB": u}) for s, u in GEMM_VARIANTS[1:]]
    jobs += [("chain", {"STAGES": s}) for s in CHAIN_VARIANTS[1:]]
    with tempfile.TemporaryDirectory() as d:
        dirs = [Path(d) / str(i) for i in range(len(jobs))]
        for p in dirs:
            p.mkdir()
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda a: _build(*a), [(*j, p) for j, p in zip(jobs, dirs)]))
        gemm_libs = [("shipped", shift_matmul._lib())] + [
            (f"max_stages{j[1]['MAX_STAGES']} ksub{j[1]['KSUB']}", lib)
            for j, lib in zip(jobs, built) if j[0] == "gemm"]
        chain_libs = [("shipped", qblocks._lib())] + [
            (f"stages{j[1]['STAGES']}", lib) for j, lib in zip(jobs, built) if j[0] == "chain"]
        rng = np.random.default_rng(0)
        g_rows, g_failed = _gemm_rows(gemm_libs, rng)
        c_rows, c_failed = _chain_rows(chain_libs, rng)
    print(json.dumps({"card": card, "rows": g_rows + c_rows}))
    return 1 if g_failed or c_failed else 0


if __name__ == "__main__":
    sys.exit(main())
