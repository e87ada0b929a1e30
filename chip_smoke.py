"""Drives the PyTorch/CUDA port (``tf2_tpu_torch``) on one NVIDIA GPU and
checks it. Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
 1. card     nvidia-smi name and power limit; fails without a CUDA device.
 2. build    compiles tf2_tpu_torch/kernels/csrc/*.cu with nvcc for sm_90a.
 3. artifact full-width ResNet-50 (224x224, 1000 classes, depths 3-4-6-3)
             through the port's transform (init_params(seed=0), BN fold,
             W4-PoT quantize, synthetic activation scales), saved and
             loaded back as an artifact; Engines at batch 64 and 1 and on
             the CPU at batch 1, each unfused and with block_fusion=True.
 4. kernels  each of the four conv/GEMM kernels against its plain version
             on the card with 0 mismatches: every conv/dense node of the path
             at batch 64 and 1 on its real input, the same shapes with relu
             flipped on random inputs and with +-127 inputs on
             max-magnitude weights, and ragged shapes. Times each kernel,
             its plain version and a library yardstick (torch._int_mm for
             the GEMMs, bf16 F.conv2d for the convs) with CUDA events at
             the batch-64 shapes.
 5. main     Engine.run at batch 64 and 1 with launch counts per forward
             (33 / 1 / 13 / 7 / 0), finite (B, 1000) logits, every node
             equal to the plain path on the card and, at batch 1, to the
             Engine on the CPU; Engine.benchmark img/s and latency.
 6. chains   Engine(block_fusion=True) at batch 64 and 1 from the same
             artifact: every qblockchain node against the plain chain with
             0 mismatches on its real input, with the adds' relu flipped,
             with +-127 inputs on +-127 weights, and ragged chains; each
             chain timed at batch 64 (kernel, plain, bound) and its kernel
             at batch 1.
 7. fused    Engine(block_fusion=True).run at batch 64 and 1: launch counts
             per forward (6 / 1 / 0 / 7 / 4), every node equal to the plain
             path and, at batch 1, to the fused Engine on the CPU; logits
             equal to phase 5's bit for bit; Engine.benchmark beside it.
Prints the kernels JSON line (launches: qblockchain's from phase 7, the
others' from phase 5), the card line and, last, the contract line; the
per-shape timings go to stderr as one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same source
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "qmatmul_pot4": ("tf2_tpu_torch/kernels/csrc/shift_matmul.cu",
                     "tf2_tpu/kernels/shift_matmul.py:40"),
    "qmatmul_int8": ("tf2_tpu_torch/kernels/csrc/shift_matmul.cu",
                     "tf2_tpu/kernels/shift_matmul.py:59"),
    "qconv_s1": ("tf2_tpu_torch/kernels/csrc/qconv.cu", "tf2_tpu/kernels/qconv.py:98"),
    "qconv_s2": ("tf2_tpu_torch/kernels/csrc/qconv.cu", "tf2_tpu/kernels/qconv.py:166"),
    "qblockchain": ("tf2_tpu_torch/kernels/csrc/qblocks.cu", "tf2_tpu/kernels/qblocks.py:104"),
}
EXPECTED_LAUNCHES = {"qmatmul_pot4": 33, "qmatmul_int8": 1, "qconv_s1": 13, "qconv_s2": 7,
                     "qblockchain": 0}
FUSED_LAUNCHES = {"qmatmul_pot4": 6, "qmatmul_int8": 1, "qconv_s1": 0, "qconv_s2": 7,
                  "qblockchain": 4}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


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


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from tf2_tpu_torch.kernels import build

    t = time.time()
    libs = build.build_all()
    log(f"build: {sorted(p.name for p in libs.values())} in {time.time() - t:.1f} s")
    for lib in libs.values():
        report = lib.parent / f"{lib.name.split('-')[0]}.log"
        if report.exists():
            log(report.read_text().strip())


def phase_artifact():
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine
    from tf2_tpu_torch.transform import load_artifact, save_artifact

    t = time.time()
    art = synthetic_quantized("resnet50", seed=0, batch=64, image=224, classes=1000,
                              depths=(3, 4, 6, 3))
    with tempfile.TemporaryDirectory() as d:
        save_artifact(d, art.graph, art.params)
        graph, params = load_artifact(d)
    for k, v in art.params.items():
        if not np.array_equal(params[k], v):
            raise RuntimeError(f"artifact round trip changed {k}")
    engines, cpu_engines = {}, {}
    for fused in (False, True):
        engines[fused] = {b: Engine(graph.with_batch_size(b), params, block_fusion=fused)
                          for b in (64, 1)}
        cpu_engines[fused] = Engine(graph.with_batch_size(1), params, device="cpu",
                                    block_fusion=fused)
    log(f"artifact: {len(params)} tensors, {art.size_bytes() / 1e6:.1f} MB, "
        f"transform + save + load + engines {time.time() - t:.1f} s")
    return engines, cpu_engines


def _conv_node(node):
    """The node without its fused input quantize: the kernel's own work."""
    from tf2_tpu_torch.graph import Node

    attrs = {k: v for k, v in node.attrs.items() if k != "s_in"}
    return Node(node.name, node.op, node.inputs, node.params, attrs)


def _call(node, params, x_q, plain=False):
    from tf2_tpu_torch.kernels import dispatch

    if node.op == "qconv2d":
        return dispatch.qconv2d(_conv_node(node), params, x_q, plain=plain)
    if node.op == "qblockchain":
        return dispatch.qblockchain(node, params, x_q, plain=plain)
    return dispatch.qdense(node, params, x_q, plain=plain)


def _which_kernel(node, params, x_q) -> str:
    from tf2_tpu_torch import kernels

    before = kernels.launch_counts()
    _call(node, params, x_q)
    after = kernels.launch_counts()
    used = [k for k in after if after[k] != before[k]]
    if len(used) != 1:
        raise RuntimeError(f"{node.name}: launched {used}, expected one kernel")
    return used[0]


def _taps(size: int, k: int, s: int, p0: int, out: int) -> tuple[int, int]:
    """Along one axis of a conv: (input positions read, taps that fall
    inside the input summed over the outputs)."""
    idx = np.arange(out)[:, None] * s - p0 + np.arange(k)[None, :]
    inside = (idx >= 0) & (idx < size)
    return len(np.unique(idx[inside])), int(inside.sum())


def _work(node, params, x_q, y) -> tuple[float, float]:
    """(bytes, operations) the function needs: each input element the
    function reads, read once (a strided 1x1 conv reads one pixel in four),
    the weights, es and eb read once, the output written once; 2 operations
    per multiply-accumulate, counting only the taps inside the image (not
    those on the zero padding)."""
    from tf2_tpu_torch.kernels import qconv

    if node.op == "qblockchain":
        return _chain_work(node, params, x_q, y)
    if node.op == "qconv2d":
        kh, kw, cin, cout = node.attrs["kshape"]
        k = kh * kw * cin
        b, h, w, _ = x_q.shape
        s = node.attrs["strides"][0]
        (ph0, ph1), (pw0, pw1) = qconv.resolve_pads(node.attrs.get("padding", "SAME"),
                                                    kh, kw, s, s, h, w)
        rows, taps_y = _taps(h, kh, s, ph0, y.shape[1])
        cols, taps_x = _taps(w, kw, s, pw0, y.shape[2])
        x_bytes, macs = b * rows * cols * cin, b * taps_y * taps_x * cin * cout
    else:
        k, cout = node.attrs["kshape"]
        x_bytes, macs = x_q.numel(), x_q.numel() * cout
    w_bytes = k * cout // 2 if node.attrs["wfmt"] == "pot4" else k * cout
    return x_bytes + w_bytes + 8 * cout + y.numel(), 2.0 * macs


def _chain_work(node, params, x_q, y) -> tuple[float, float]:
    """(bytes, operations) of a chain: its input read once, its output
    written once, every weight, es and eb read once (the values between
    blocks are the function's own); 2 operations per multiply-accumulate of
    each 1x1, of the downsamples and of the 3x3 taps inside the image."""
    b, h, w, cin = x_q.shape
    _, taps_y = _taps(h, 3, 1, 1, h)
    _, taps_x = _taps(w, 3, 1, 1, w)
    macs = 0
    for battrs in node.attrs["blocks"]:
        cm, cout = battrs["cm"], battrs["cout"]
        macs += b * h * w * (cin * cm + cm * cout) + b * taps_y * taps_x * cm * cm
        if battrs["down"]:
            macs += b * h * w * cin * cout
        cin = cout
    param_bytes = sum(params[p].numel() * params[p].element_size() for p in node.params)
    return x_q.numel() + y.numel() + param_bytes, 2.0 * macs


def _library(node, params, x_q):
    """One PyTorch call computing the same product (no epilogue), used
    only as a time: torch._int_mm for GEMMs, bf16 F.conv2d for convs. No
    single PyTorch call computes a chain of bottleneck blocks: None."""
    import torch.nn.functional as F

    from tf2_tpu_torch.kernels import qconv
    from tf2_tpu_torch.transform import potq

    if node.op == "qblockchain":
        return None
    w = params[node.params[0]]
    if node.op == "qconv2d":
        kshape = tuple(node.attrs["kshape"])
        kh, kw, cin, cout = kshape
        w = qconv.decode_hwio(w, node.attrs["wfmt"], kshape)
        s = node.attrs["strides"][0]
        if (kh, kw, s) != (1, 1, 1):
            xb = x_q.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            return lambda: F.conv2d(xb, wb, stride=s, padding=kh // 2)
        x2, w2 = x_q.reshape(-1, cin), w.reshape(cin, cout)
    else:
        x2 = x_q
        w2 = w if node.attrs["wfmt"] == "int8" else potq.pot_decode(
            potq.unpack_codes(w, node.attrs["kshape"][0]))
    return lambda: torch._int_mm(x2, w2)


def _adversarial(node, params, rng, x_q, extreme: bool):
    """+-127 inputs on weights of the largest magnitude (pot4 +-64, int8
    +-127). ``extreme``: every input +127 and every weight +max, the largest
    accumulator, with es placing it just inside the int8 range; otherwise
    random signs with es large enough that outputs clip at both ends.
    Returns (params, x)."""
    dev = x_q.device
    p = dict(params)
    w = params[node.params[0]]
    pot4 = node.attrs["wfmt"] == "pot4"
    wmax = 64 if pot4 else 127
    if extreme:
        wv = np.full(tuple(w.shape), 0x77 if pot4 else 127, np.uint8 if pot4 else np.int8)
        x = torch.full_like(x_q, 127)
    else:
        choices = (np.array([0x77, 0xFF, 0x7F, 0xF7], np.uint8) if pot4
                   else np.array([127, -127], np.int8))
        wv = rng.choice(choices, size=tuple(w.shape))
        x = torch.as_tensor(rng.choice(np.array([127, -127], np.int8),
                                       size=tuple(x_q.shape))).to(dev)
    p[node.params[0]] = torch.as_tensor(wv).to(dev)
    kshape = node.attrs["kshape"]
    k = int(np.prod(kshape[:-1]))
    scale = rng.uniform(0.2, 0.99, kshape[-1]) if extreme else \
        rng.uniform(0.5, 8.0, kshape[-1]) * np.sqrt(k)
    p[node.params[1]] = torch.as_tensor((scale / (wmax * k)).astype(np.float32)).to(dev)
    return p, x


def _ragged_cases(rng, dev):
    """Shapes off the main path: ragged M/N/K, cin 130, VALID padding."""
    from tf2_tpu_torch.graph import Node
    from tf2_tpu_torch.transform import potq

    cases = []
    for b, h, w, cin, cout, kk, s, pad, wfmt in [
            (2, 9, 9, 130, 40, 3, 1, "SAME", "pot4"),
            (2, 13, 13, 24, 32, 3, 2, "VALID", "int8"),
            (2, 15, 15, 32, 64, 3, 1, "SAME", "pot4"),
            (3, 7, 7, 48, 200, 1, 1, "SAME", "pot4"),
            (1, 28, 28, 3, 64, 7, 2, "SAME", "int8")]:
        k = kk * kk * cin
        if wfmt == "pot4":
            wp = potq.pack_codes(rng.integers(0, 16, (k, cout)).astype(np.uint8))
        else:
            wp = rng.integers(-127, 128, (kk, kk, cin, cout), dtype=np.int8)
        name = f"ragged_{b}x{h}x{w}x{cin}_{kk}x{kk}s{s}_{cout}"
        node = Node(name, "qconv2d", ("x",), (f"{name}.w", f"{name}.es", f"{name}.eb"),
                    {"kshape": [kk, kk, cin, cout], "strides": [s, s], "padding": pad,
                     "groups": 1, "relu": True, "wfmt": wfmt})
        cases.append((node, (b, h, w, cin), wp, cout))
    for m, k, n, wfmt in [(100, 576, 64, "pot4"), (49, 2048, 1000, "int8"),
                          (1, 2048, 1000, "pot4"), (130, 64, 130, "pot4")]:
        wp = (potq.pack_codes(rng.integers(0, 16, (k, n)).astype(np.uint8))
              if wfmt == "pot4" else rng.integers(-127, 128, (k, n), dtype=np.int8))
        name = f"ragged_{m}x{k}x{n}"
        node = Node(name, "qdense", ("x",), (f"{name}.w", f"{name}.es", f"{name}.eb"),
                    {"kshape": [k, n], "relu": False, "wfmt": wfmt})
        cases.append((node, (m, k), wp, n))
    out = []
    for node, xshape, wp, n in cases:
        params = {node.params[0]: torch.as_tensor(wp).to(dev),
                  node.params[1]: torch.as_tensor(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(dev),
                  node.params[2]: torch.as_tensor(rng.standard_normal(n).astype(np.float32)).to(dev)}
        x = torch.as_tensor(rng.integers(-127, 128, xshape, dtype=np.int8)).to(dev)
        out.append((node, params, x))
    return out


def _flip_relu(node):
    """The node with its relu flipped; a chain's in every block's add."""
    from tf2_tpu_torch.graph import Node

    if node.op == "qblockchain":
        attrs = dict(node.attrs, blocks=[dict(blk, relu=not blk["relu"])
                                         for blk in node.attrs["blocks"]])
    else:
        attrs = dict(node.attrs, relu=not node.attrs["relu"])
    return Node(node.name, node.op, node.inputs, node.params, attrs)


def _chain_adversarial(node, params, rng, x_q, extreme: bool):
    """+-127 inputs on +-127 weights in every conv of a chain. ``extreme``:
    every input and weight +127, the largest accumulators, with es placing
    each conv's largest sum just inside the int8 range; otherwise random
    signs with es large enough that outputs clip at both ends. Returns
    (params, x)."""
    dev = x_q.device
    p = dict(params)
    for wname, esname in zip(node.params[0::3], node.params[1::3]):
        w = params[wname]
        n = w.shape[-1]
        k = w.numel() // n
        if extreme:
            wv = np.full(tuple(w.shape), 127, np.int8)
            scale = rng.uniform(0.2, 0.99, n)
        else:
            wv = rng.choice(np.array([127, -127], np.int8), size=tuple(w.shape))
            scale = rng.uniform(0.5, 8.0, n) * np.sqrt(k)
        p[wname] = torch.as_tensor(wv).to(dev)
        p[esname] = torch.as_tensor((scale / (127 * k)).astype(np.float32)).to(dev)
    if extreme:
        return p, torch.full_like(x_q, 127)
    return p, torch.as_tensor(rng.choice(np.array([127, -127], np.int8),
                                         size=tuple(x_q.shape))).to(dev)


def _ragged_chains(rng, dev):
    """Chains off the main path: bands that do not divide H, Cm not a
    multiple of 16, Cin != Cout with a downsample, 1-3 blocks with the
    adds' relu on and off, stage 4 at batch 1. On 132 SMs the first three
    take bands of 2, 2 and 5 rows. -> (blocks, x, name)."""
    cases = []
    for b, h, w, cin, cm, cout, nblocks, down in [
            (64, 9, 13, 48, 40, 64, 2, True), (64, 9, 13, 64, 40, 64, 1, False),
            (96, 12, 12, 32, 32, 96, 3, True), (3, 8, 8, 64, 16, 64, 3, False),
            (1, 7, 7, 2048, 512, 2048, 2, False)]:
        for relu in (False, True):
            blocks = []
            for i in range(nblocks):
                k = cin if i == 0 else cout
                convs = [("1", k, cm), ("2", 9 * cm, cm), ("3", cm, cout)]
                if down and i == 0:
                    convs.append(("d", k, cout))
                blk = {"sa_over_so": float(rng.uniform(0.5, 1.5)),
                       "sb_over_so": float(rng.uniform(0.5, 1.5)), "relu": relu}
                for key, kk, n in convs:
                    wshape = (3, 3, cm, cm) if key == "2" else (kk, n)
                    blk["w" + key] = rng.integers(-127, 128, wshape, dtype=np.int8)
                    blk["es" + key] = (rng.uniform(0.5, 2.0, n) * 40
                                       / (127 * 127 * np.sqrt(kk))).astype(np.float32)
                    blk["eb" + key] = rng.normal(0, 3, n).astype(np.float32)
                blocks.append({k_: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray)
                               else v for k_, v in blk.items()})
            x = torch.as_tensor(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(dev)
            name = f"ragged_{b}x{h}x{w}x{cin}_cm{cm}_{cout}_{nblocks}blocks_relu{int(relu)}"
            cases.append((blocks, x, name))
    return cases


class KernelStats:
    """Per-kernel comparison and timing totals."""

    def __init__(self):
        self.rows = []
        self.k = {name: {"max_abs_err": 0, "checks": 0, "ms": 0.0, "plain_ms": 0.0,
                         "library_ms": 0.0, "bound_ms": 0.0, "bytes_bound_ms": 0.0}
                  for name in KERNELS}
        self.mismatches = []

    def check(self, kernel, what, y, yp):
        """Record the kernel's output ``y`` against the plain version's."""
        torch.cuda.synchronize()
        err = int((y.to(torch.int32) - yp.to(torch.int32)).abs().max())
        s = self.k[kernel]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["checks"] += 1
        if err or y.shape != yp.shape:
            self.mismatches.append(f"{kernel} {what}: max |err| {err}")
        return y

    def compare(self, kernel, node, params, x_q, what):
        return self.check(kernel, f"{node.name} {what}", _call(node, params, x_q),
                          _call(node, params, x_q, plain=True))

    def time(self, kernel, node, params, x_q, y, mult):
        ms = cuda_ms(lambda: _call(node, params, x_q), 20)
        plain_ms = cuda_ms(lambda: _call(node, params, x_q, plain=True), 3)
        library = _library(node, params, x_q)
        library_ms = cuda_ms(library, 20) if library else None
        nbytes, ops = _work(node, params, x_q, y)
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = ops / H100_INT8_OPS_PER_S * 1e3
        s = self.k[kernel]
        s["ms"] += ms * mult
        s["plain_ms"] += plain_ms * mult
        s["library_ms"] = None if library_ms is None else s["library_ms"] + library_ms * mult
        s["bound_ms"] += max(bytes_ms, ops_ms) * mult
        s["bytes_bound_ms"] += bytes_ms * mult if bytes_ms >= ops_ms else 0.0
        if node.op == "qblockchain":
            shape = {"blocks": len(node.attrs["blocks"]),
                     "cm": [blk["cm"] for blk in node.attrs["blocks"]]}
        else:
            shape = {"kshape": node.attrs["kshape"], "strides": node.attrs.get("strides"),
                     "wfmt": node.attrs["wfmt"]}
        self.rows.append({"kernel": kernel, "node": node.name, "count": mult,
                          "x": list(x_q.shape), **shape,
                          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                          "bytes_ms": bytes_ms, "ops_ms": ops_ms})


def phase_kernels(engines, images):
    """Holds every kernel against its plain version; returns (stats, the
    plain path's values of every node at each batch)."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.kernels import dispatch

    rng = np.random.default_rng(1)
    stats = KernelStats()
    plain_envs = {}
    for b, eng in engines.items():
        _, env = execute(eng.graph, intermediates=True, plain=True)(eng.params,
                                                                    image=images[b])
        plain_envs[b] = env
        groups: dict[str, list] = {}
        for node in eng.graph.nodes:
            if node.op not in ("qconv2d", "qdense"):
                continue
            x = env[node.inputs[0]]
            if "s_in" in node.attrs:
                x = dispatch.quantize(x, node.attrs["s_in"])
            key = json.dumps([node.op, node.attrs["kshape"], node.attrs.get("strides"),
                              node.attrs.get("padding"), node.attrs["wfmt"], list(x.shape)])
            groups.setdefault(key, []).append((node, x))
        for members in groups.values():
            node, x = members[0]
            kernel = _which_kernel(node, eng.params, x)
            for n, xm in members:
                y = stats.compare(kernel, n, eng.params, xm, f"b{b} main-path input")
            xr = torch.as_tensor(rng.integers(-127, 128, tuple(x.shape), dtype=np.int8)).to(x.device)
            stats.compare(kernel, _flip_relu(node), eng.params, xr, f"b{b} random, relu flipped")
            for extreme in (True, False):
                p, xa = _adversarial(node, eng.params, rng, x, extreme)
                stats.compare(kernel, node, p, xa, f"b{b} +-127 extreme={extreme}")
            if b == 64:
                stats.time(kernel, node, eng.params, x, y, len(members))
    for node, params, x in _ragged_cases(rng, images[1].device):
        kernel = _which_kernel(node, params, x)
        for n in (node, _flip_relu(node)):
            stats.compare(kernel, n, params, x, "ragged")
    if stats.mismatches:
        raise RuntimeError("kernels disagree with their plain versions:\n"
                           + "\n".join(stats.mismatches))
    log("kernels: " + ", ".join(f"{k} {v['checks']} checks max |err| {v['max_abs_err']}"
                                for k, v in stats.k.items()))
    return stats, plain_envs


def phase_chains(engines, images, stats):
    """Holds every chain of the block-fused Engines against the plain
    chain, then the ragged chains; returns the plain path's values of every
    node at each batch."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.kernels import qblocks

    rng = np.random.default_rng(2)
    plain_envs = {}
    for b, eng in engines.items():
        _, env = execute(eng.graph, intermediates=True, plain=True)(eng.params,
                                                                    image=images[b])
        plain_envs[b] = env
        for node in eng.graph.nodes:
            if node.op != "qblockchain":
                continue
            x = env[node.inputs[0]]
            y = stats.compare("qblockchain", node, eng.params, x, f"b{b} main-path input")
            xr = torch.as_tensor(rng.integers(-127, 128, tuple(x.shape), dtype=np.int8)).to(x.device)
            stats.compare("qblockchain", _flip_relu(node), eng.params, xr,
                          f"b{b} random, relu flipped")
            for extreme in (True, False):
                p, xa = _chain_adversarial(node, eng.params, rng, x, extreme)
                stats.compare("qblockchain", node, p, xa, f"b{b} +-127 extreme={extreme}")
            if b == 64:
                stats.time("qblockchain", node, eng.params, x, y, 1)
            else:
                log(f"chain {node.name} b{b}: "
                    f"{cuda_ms(lambda: _call(node, eng.params, x), 20):.6f} ms")
    for blocks, x, name in _ragged_chains(rng, images[1].device):
        stats.check("qblockchain", name, qblocks.qblockchain(x, blocks),
                    qblocks.qblockchain_plain(x, blocks))
    if stats.mismatches:
        raise RuntimeError("the chain kernel disagrees with the plain chain:\n"
                           + "\n".join(stats.mismatches))
    log(f"chains: {stats.k['qblockchain']['checks']} checks, max |err| "
        f"{stats.k['qblockchain']['max_abs_err']}")
    return plain_envs


def phase_main(engines, cpu_engine, images, plain_envs, expected, same_as=None):
    """A path through Engine.run: launch counts per forward must equal
    ``expected``; returns (launches per b64 forward, summary, logits by
    batch). At batch 1 every node and the logits must also equal the
    Engine on the CPU, whose plain path the CPU tests hold against
    tf2_tpu; with ``same_as`` the logits must equal those bit for bit."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.graph import execute

    summary, launches, all_logits = {}, None, {}
    for b, eng in engines.items():
        kernels.reset_launch_counts()
        logits = eng.run(image=images[b])
        counts = kernels.launch_counts()
        if counts != expected:
            raise RuntimeError(f"b{b}: launches per forward {counts}, expected {expected}")
        if b == 64:
            launches = counts
        all_logits[b] = logits
        if tuple(logits.shape) != (b, 1000) or not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"b{b}: logits {tuple(logits.shape)} not finite (B, 1000)")
        if same_as is not None and not torch.equal(logits, same_as[b]):
            raise RuntimeError(f"b{b}: logits differ from the default Engine's")
        _, env = execute(eng.graph, intermediates=True)(eng.params, image=images[b])
        differ = [n.name for n in eng.graph.nodes
                  if not torch.equal(env[n.name], plain_envs[b][n.name])]
        if differ or not torch.equal(logits, plain_envs[b][eng.graph.outputs[0]]):
            raise RuntimeError(f"b{b}: nodes differ from the plain path: {differ[:5]}")
        if b == 1:
            t = time.time()
            cpu_logits, cpu_env = execute(cpu_engine.graph, intermediates=True)(
                cpu_engine.params, image=images[b].cpu())
            differ = [n.name for n in eng.graph.nodes
                      if not torch.equal(env[n.name].cpu(), cpu_env[n.name])]
            if differ or not torch.equal(logits.cpu(), cpu_logits):
                raise RuntimeError(f"b1: nodes differ from the Engine on the CPU: {differ[:5]}")
            log(f"main b1: {len(eng.graph.nodes)} nodes equal the Engine on the CPU "
                f"({time.time() - t:.1f} s on the CPU)")
        bench = eng.benchmark(iters=20 if b == 64 else 100, reps=3, image=images[b])
        summary[f"b{b}"] = {"img_per_s": bench["throughput_per_s"],
                            "latency_ms": bench["latency_s"] * 1e3,
                            "per_rep_ms": [t * 1e3 for t in bench["per_rep_s"]],
                            "nodes_checked": len(eng.graph.nodes),
                            "logits_absmax": float(logits.abs().max())}
        log(f"main b{b}: {counts}, {len(eng.graph.nodes)} nodes equal the plain path, "
            f"{bench['throughput_per_s']:.1f} img/s, {bench['latency_s'] * 1e3:.3f} ms/forward")
    return launches, summary, all_logits


def main() -> int:
    smi = phase_card()
    phase_build()
    engines, cpu_engines = phase_artifact()
    rng = np.random.default_rng(0)
    images = {b: torch.as_tensor(rng.standard_normal(
        (b, 224, 224, 3), dtype=np.float32)).cuda() for b in (64, 1)}
    stats, plain_envs = phase_kernels(engines[False], images)
    launches, summary, logits = phase_main(engines[False], cpu_engines[False], images,
                                           plain_envs, EXPECTED_LAUNCHES)
    fused_envs = phase_chains(engines[True], images, stats)
    fused_launches, summary["block_fusion"], _ = phase_main(
        engines[True], cpu_engines[True], images, fused_envs, FUSED_LAUNCHES, same_as=logits)
    launches["qblockchain"] = fused_launches["qblockchain"]
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        s = stats.k[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_bound_ms"] * 2 >= s["bound_ms"] else "operations",
            "library_ms": s["library_ms"]})
    log(json.dumps({"checks": {k: v["checks"] for k, v in stats.k.items()},
                    "per_shape_b64": stats.rows}))
    print(json.dumps({"main_path": summary, "card": smi}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
