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
             the CPU at batch 1: default, block_fusion=True,
             phase_stem=True and optimize=True.
 4. kernels  each of the conv/GEMM kernels against its plain version
             on the card with 0 mismatches: every conv/dense node of the path
             at batch 64 and 1 on its real input, the same shapes with relu
             flipped on random inputs and with +-127 inputs on
             max-magnitude weights, and ragged shapes that with the zoo's
             reach every variant of the conv plan (each printed). Times each
             kernel (a conv's row names the plan it took),
             its plain version and a library yardstick (torch._int_mm for
             the GEMMs, bf16 F.conv2d for the convs) with CUDA events at
             the batch-64 shapes.
 5. main     Engine.run at batch 64 and 1 with launch counts per forward
             (33 / 1 / 13 / 7 / 0 / 0 / 0 / 0 / 0), finite (B, 1000) logits,
             every node equal to the plain path on the card and, at batch 1,
             to the Engine on the CPU; Engine.benchmark img/s and latency.
 6. chains   Engine(block_fusion=True) at batch 64 and 1 from the same
             artifact: every qblockchain node against the plain chain with
             0 mismatches on its real input, with the adds' relu flipped,
             with +-127 inputs on +-127 weights, and ragged chains; each
             chain timed at batch 64 (kernel, plain, bound) and its kernel
             at batch 1.
 7. fused    Engine(block_fusion=True).run at batch 64 and 1: launch counts
             per forward (6 / 1 / 0 / 7 / 4 / 0 / 0 / 0 / 0), every node
             equal to the plain path and, at batch 1, to the fused Engine on
             the CPU; logits equal to phase 5's bit for bit;
             Engine.benchmark beside it.
 8. googlenet full-width GoogLeNet (224x224, 1000 classes, two LRNs): the
             artifact round trip, Engines at batch 64 and 1 and on the CPU
             at batch 1, default and with merge_1x1=True. Every conv and
             dense node of both graphs against its plain version as in
             phase 4 (the 5x5 convs, cout 16-384, merged widths such as
             296); every qlrn node against qlrn_plain on its real input at
             both batches, at the same shapes on random and on +-127 inputs
             under three (s_in, s_out, alpha) sets at radius 1 and 2 and
             beta 0.75, 0.5, 0.6 and 1.0, and on ragged shapes (odd M,
             C = 13, C < 2r + 1, M = 1), all with 0 mismatches; qlrn timed
             at batch 64 (kernel, plain, bound, F.local_response_norm as
             the yardstick); its stem as in phase 12. Then both Engines as
             in phase 5: launch counts per forward
             (37 / 1 / 19 / 1 / 0 / 2 / 0 / 0 / 0 default,
             10 / 10 / 19 / 1 / 0 / 2 / 0 / 0 / 0 merged), every node equal
             to the plain path and at batch 1 to the CPU Engine, merged
             logits equal to the default's bit for bit, Engine.benchmark.
 9. squeezenet  the same for SqueezeNet v1.1, which has no LRN: launch
             counts 16 / 1 / 8 / 1 / 0 / 0 / 0 / 0 / 0 default and
             12 / 1 / 8 / 1 / 0 / 0 / 0 / 0 / 0 merged (fires 2-5 merge
             e1x1 into an int8 3x3).
10. vit      full-width ViT-B/16 (224x224, 1000 classes, depth 12, dim 768,
             12 heads) at W8 with the int8 residual stream, vit_b16 (T = 196)
             then vit_b16_cls (T = 197): the artifact (the position
             embedding, class token and layer-norm parameters drawn from a
             seeded generator) round trip, Engines at batch 64 and 1 and on
             the CPU at batch 1. Every qdense node, with and without the
             folded residual, against its plain version as in phase 4 (its
             GEMMs timed per shape at batch 64, outside the kernels line);
             every qattention_core node against qattention_plain on its real
             input at both batches, on random qkv under three (s_in, s_out)
             pairs from flat to peaked softmax, on +-127 inputs, and on
             ragged (N, T, heads, hd), T up to 4,096 (streamed through
             shared memory), all with 0 mismatches; qattention
             timed at batch 64 (kernel, plain, bound,
             F.scaled_dot_product_attention on the dequantized bf16 q, k, v
             as the yardstick). Then both Engines as in phase 5: launch
             counts 0 / 50 / 0 / 0 / 0 / 0 / 12 / 0 / 0 a forward, every
             node equal to the plain path and at batch 1 to the CPU Engine,
             finite (B, 1000) logits, Engine.benchmark.
11. stem Engines  (after phase 7) ResNet-50's Engine(phase_stem=True) and
             Engine(optimize=True) as phases 4-5: every conv node against
             its plain version (the space-to-depth stem a 4x4 stride-1 conv
             on 12 channels), launch counts 33 / 1 / 13 / 6 / 0 / 0 / 0 / 1
             / 0 and 33 / 1 / 14 / 6 / 0 / 0 / 0 / 0 / 0, every node equal to
             the plain path and at batch 1 to the CPU Engine, logits equal to
             phase 5's bit for bit, Engine.benchmark.
12. stems    for each model's stem (ResNet-50 here, then inside phases 8, 9
             and 13) at batch 64 and 1: fused_qstem on the f32 image and the
             stem's real weights, eff_scale, eff_bias and s_in, its
             launches counted from 0 (one qstem launch), its output equal to
             the Engine's stem node and to qstem_plain, then on the int8
             image, relu on and off, and +-127; the wpack2 node (the conv
             kernel's stride-(2, 1) entry) equal to the Engine's stem node
             and to its plain version, on random and +-127 packed inputs;
             the space-to-depth route equal to the Engine's stem node. The
             four routes timed side by side (the whole stem node and its
             kernel alone) beside bf16 F.conv2d and the byte bound; qstem
             and the stride-(2, 1) conv timed at ResNet-50's b64 stem into
             the kernels line. Then ragged stems (k 5 and 1, odd H and W,
             cin 1, 2, 4, cout 130, batch 3) and ragged packed convs.
13. ssd      full-width SSD (256x256, 21 classes, 1,008 priors, W4-PoT)
             under both score cases (random and background-dominated,
             tf2_tpu_torch/bench/ssd_cases.py): the artifact round trip,
             Engines at batch 64 and 1 and on the CPU at batch 1, every conv
             node against its plain version, its stem as in phase 12, then
             as in phase 5 with (B, 100, 6) detections: launch counts
             0 / 0 / 8 / 6 / 0 / 0 / 0 / 0 / 0, every node equal to the
             plain path and at batch 1 to the CPU Engine (the detections
             too), Engine.benchmark.
14. vit 384  ViT-B/16 fine-tuned at 384x384 (vit_b16_cls, T = 577: K and
             V resident, three passes over chunks of keys) as phase 10 at
             batch 8 and 1: every qdense and qattention_core node against
             its plain version, launch counts 0 / 50 / 0 / 0 / 0 / 0 / 12 /
             0 / 0, every node equal to the plain path and at batch 1 to the
             CPU Engine, Engine.benchmark; the kernel timed at batch 64 on
             random qkv of its shape (64, 577, 2304) beside its plain
             version, bf16 SDPA and the bound (a per-shape row, outside the
             kernels line).
15. coverage graphs outside the zoo (tf2_tpu_torch/bench/coverage_cases.py)
             whose nodes the kernels do not take: a CNN with a depthwise
             3x3, a groups=2 3x3, a 3x3/s3 and a (1, 2)-strided conv, and a
             ViT with heads 24 wide. Engine.plain_nodes printed and equal to
             the nodes no kernel takes, those nodes run plain on the card,
             the others on their kernels, every node equal to
             Engine(device="cpu").
Every zoo Engine on the card (phases 3-14) must have empty plain_nodes:
the coverage plan sends none of the zoo's nodes to a plain version.
Launch counts are in the order (qmatmul_pot4, qmatmul_int8, qconv_s1,
qconv_s2, qblockchain, qlrn, qattention, qconv_s2x1, qstem). Prints the
summary line (every path's numbers, the stem routes, the run's wall time),
the kernels JSON line (launches: qblockchain's from phase 7, qconv_s2x1's
from phase 11's phase_stem Engine, qstem's from the b64 fused_qstem call on
ResNet-50's stem (no Engine routes to it), qlrn's from phase 8,
qattention's from phase 10, the others' from phase 5; times at ResNet-50's
shapes, qlrn's at GoogLeNet's, qattention's at vit_b16's), the card line
and, last, the contract line; the per-shape timings go to stderr as one
JSON line.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same source
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores, same source
H100_F64_OPS_PER_S = 34e12     # f64 outside the tensor cores, same source
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "qmatmul_pot4": ("tf2_tpu_torch/kernels/csrc/shift_matmul.cu",
                     "tf2_tpu/kernels/shift_matmul.py:40"),
    "qmatmul_int8": ("tf2_tpu_torch/kernels/csrc/shift_matmul.cu",
                     "tf2_tpu/kernels/shift_matmul.py:59"),
    "qconv_s1": ("tf2_tpu_torch/kernels/csrc/qconv.cu", "tf2_tpu/kernels/qconv.py:98"),
    "qconv_s2": ("tf2_tpu_torch/kernels/csrc/qconv.cu", "tf2_tpu/kernels/qconv.py:166"),
    "qblockchain": ("tf2_tpu_torch/kernels/csrc/qblocks.cu", "tf2_tpu/kernels/qblocks.py:104"),
    "qlrn": ("tf2_tpu_torch/kernels/csrc/qlrn.cu", "tf2_tpu/kernels/qlrn.py:66"),
    "qattention": ("tf2_tpu_torch/kernels/csrc/qattention.cu",
                   "tf2_tpu/kernels/qattention.py:42"),
    # the wpack2 stem's stride-(2, 1) conv, which the reference runs as a
    # bf16 lax conv in XLA, not in Pallas
    "qconv_s2x1": ("tf2_tpu_torch/kernels/csrc/qconv.cu",
                   "tf2_tpu/kernels/dispatch.py:154 (wpack2 conv, XLA not Pallas)"),
    "qstem": ("tf2_tpu_torch/kernels/csrc/qstem.cu", "tf2_tpu/kernels/qstem.py:144"),
}
KERNEL_NAMES = tuple(KERNELS)


def _launches(*counts):
    return dict(zip(KERNEL_NAMES, counts))


# launches a forward: (pot4 GEMM, int8 GEMM, conv s1, conv s2, chain, qlrn,
# attention, conv s2x1, stem)
EXPECTED_LAUNCHES = _launches(33, 1, 13, 7, 0, 0, 0, 0, 0)
FUSED_LAUNCHES = _launches(6, 1, 0, 7, 4, 0, 0, 0, 0)
STEM_LAUNCHES = {"phase_stem": _launches(33, 1, 13, 6, 0, 0, 0, 1, 0),
                 "optimize": _launches(33, 1, 14, 6, 0, 0, 0, 0, 0)}
RESNET_OPTIONS = {"default": {}, "block_fusion": {"block_fusion": True},
                  "phase_stem": {"phase_stem": True}, "optimize": {"optimize": True}}
ZOO_OPTIONS = {"default": {}, "merge_1x1": {"merge_1x1": True}}
ZOO_LAUNCHES = {  # model -> {option: launches}
    "googlenet": {"default": _launches(37, 1, 19, 1, 0, 2, 0, 0, 0),
                  "merge_1x1": _launches(10, 10, 19, 1, 0, 2, 0, 0, 0)},
    "squeezenet_v1_1": {"default": _launches(16, 1, 8, 1, 0, 0, 0, 0, 0),
                        "merge_1x1": _launches(12, 1, 8, 1, 0, 0, 0, 0, 0)},
}
VIT_LAUNCHES = _launches(0, 50, 0, 0, 0, 0, 12, 0, 0)
SSD_LAUNCHES = _launches(0, 0, 8, 6, 0, 0, 0, 0, 0)
# ragged stems: (b, h, w, cin, cout, k, padding)
RAGGED_STEMS = [(3, 37, 41, 1, 16, 5, "SAME"), (3, 33, 19, 2, 24, 5, "VALID"),
                (1, 30, 30, 4, 130, 7, "SAME"), (3, 45, 31, 3, 64, 7, "SAME"),
                (2, 9, 7, 3, 8, 1, "SAME")]
# (s_in, s_out) for qattention on random qkv: the softmax from flat to peaked
ATTN_SCALES = [(0.005, 0.01), (0.02, 0.05), (0.1, 0.05)]
# (s_in, s_out, alpha) for qlrn on random inputs: the synthetic scales keep
# t within 0.4% of 1; these move it across the epilogue's range
QLRN_SCALES = [(0.0312, 0.0279, 2e-4), (0.5, 0.37, 1e-4), (0.2, 0.05, 1e-3)]
QLRN_BETAS = (0.75, 0.5, 0.6, 1.0)  # the zoo's, then others (t^beta by exp and log)


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


def load_round_trip(name: str, image: int = 224, classes: int = 1000, **kwargs):
    """The model's synthetic artifact at batch 64, saved and loaded back
    (the graph and every tensor must come back as they were). -> (graph,
    params, MB)."""
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.transform import load_artifact, save_artifact

    art = synthetic_quantized(name, seed=0, batch=64, image=image, classes=classes, **kwargs)
    with tempfile.TemporaryDirectory() as d:
        save_artifact(d, art.graph, art.params)
        graph, params = load_artifact(d)
    if graph.to_json() != art.graph.to_json():
        raise RuntimeError(f"{name}: artifact round trip changed the graph")
    for k, v in art.params.items():
        if not np.array_equal(params[k], v):
            raise RuntimeError(f"{name}: artifact round trip changed {k}")
    return graph, params, art.size_bytes() / 1e6


def zoo_engine(graph, params, **flags):
    """An Engine on the card for a zoo model: its coverage plan must send
    no node to a plain version."""
    from tf2_tpu_torch.runtime import Engine

    eng = Engine(graph, params, **flags)
    if eng.plain_nodes:
        raise RuntimeError(f"{graph.name} {flags}: nodes no kernel takes: "
                           f"{sorted(eng.plain_nodes)}")
    return eng


def make_engines(graph, params, options, batches=(64, 1)):
    """Engines on the card at each of ``batches`` and on the CPU at batch 1
    for each of ``options`` (label -> Engine flags). -> (engines[label]
    [batch], cpu_engines[label])."""
    from tf2_tpu_torch.runtime import Engine

    engines, cpu_engines = {}, {}
    for label, flags in options.items():
        engines[label] = {b: zoo_engine(graph.with_batch_size(b), params, **flags)
                          for b in batches}
        cpu_engines[label] = Engine(graph.with_batch_size(1), params, device="cpu", **flags)
    return engines, cpu_engines


def phase_artifact(name: str, options, **kwargs):
    """The model's artifact round trip and its Engines for each of
    ``options``. -> (engines[label][batch], cpu_engines[label])."""
    t = time.time()
    graph, params, mb = load_round_trip(name, **kwargs)
    engines, cpu_engines = make_engines(graph, params, options)
    log(f"artifact {name}: {len(params)} tensors, {mb:.1f} MB, "
        f"transform + save + load + engines {time.time() - t:.1f} s")
    return engines, cpu_engines


def _conv_node(node):
    """The node without its fused input quantize: the kernel's own work."""
    from tf2_tpu_torch.graph import Node

    attrs = {k: v for k, v in node.attrs.items() if k != "s_in"}
    return Node(node.name, node.op, node.inputs, node.params, attrs)


def _main_input(x_q):
    """The tensor the kernel reads first: a residual qdense's input is the
    pair (x, residual)."""
    return x_q[0] if isinstance(x_q, tuple) else x_q


def _call(node, params, x_q, plain=False):
    from tf2_tpu_torch.kernels import dispatch

    if isinstance(x_q, tuple):
        return dispatch.qdense(node, params, *x_q, plain=plain)
    if node.op == "qattention_core":
        return dispatch.qattention_core(node, params, x_q, plain=plain)
    if node.op == "qconv2d":
        return dispatch.qconv2d(_conv_node(node), params, x_q, plain=plain)
    if node.op == "qblockchain":
        return dispatch.qblockchain(node, params, x_q, plain=plain)
    if node.op == "qlrn":
        return dispatch.qlrn(node, params, x_q, plain=plain)
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


def _bound_ms(node, params, x_q, y) -> tuple[float, float]:
    """(bytes over the memory rate, operations over their peak rate) in ms
    for the function of the node on these inputs."""
    if node.op == "qlrn":
        return _qlrn_bound_ms(node, x_q)
    if node.op == "qattention_core":
        return _qattention_bound_ms(node, x_q)
    nbytes, ops = _work(node, params, x_q, y)
    return nbytes / H100_BYTES_PER_S * 1e3, ops / H100_INT8_OPS_PER_S * 1e3


def _qlrn_bound_ms(node, x_q) -> tuple[float, float]:
    """qlrn reads each int8 input once and writes each output once. Per
    element it needs 11 f32 operations (dequantize, square, alpha * win,
    + bias, two square roots, the reciprocal, two multiplies, / s_out,
    round) and, in f64, one add fewer than its window has channels."""
    c = x_q.shape[-1]
    m = x_q.numel() // c
    r = node.attrs.get("radius", 2)
    window_adds = sum(min(ch + r, c - 1) - max(ch - r, 0) for ch in range(c))
    ops_ms = (11 * m * c / H100_F32_OPS_PER_S + m * window_adds / H100_F64_OPS_PER_S) * 1e3
    return 2 * m * c / H100_BYTES_PER_S * 1e3, ops_ms


def _qattention_bound_ms(node, qkv) -> tuple[float, float]:
    """qattention's bound (``tf2_tpu_torch/bench/qattention_ab.bound_ms``)."""
    from tf2_tpu_torch.bench.qattention_ab import bound_ms

    n, t, _ = qkv.shape
    return bound_ms(n, t, node.attrs["heads"], node.attrs["dim"])


def _work(node, params, x_q, y) -> tuple[float, float]:
    """(bytes, operations) of a conv, dense or chain: each input element the
    function reads, read once (a strided 1x1 conv reads one pixel in four),
    the weights, es and eb read once, the output written once; 2 operations
    per multiply-accumulate, counting only the taps inside the image (not
    those on the zero padding)."""
    from tf2_tpu_torch.bench.conv_bound import conv_work
    from tf2_tpu_torch.kernels import qconv

    if node.op == "qblockchain":
        return _chain_work(node, params, x_q, y)
    if node.op == "qconv2d":
        kh, kw, _, _ = node.attrs["kshape"]
        _, h, w, _ = x_q.shape
        s = node.attrs["strides"][0]
        pads = qconv.resolve_pads(node.attrs.get("padding", "SAME"), kh, kw, s, s, h, w)
        return conv_work(x_q.shape, node.attrs["kshape"], (s, s), pads, node.attrs["wfmt"],
                         y.shape)
    k, cout = node.attrs["kshape"]
    xs = x_q if isinstance(x_q, tuple) else (x_q,)  # a residual is read once too
    x_bytes, macs = sum(x.numel() for x in xs), xs[0].numel() * cout
    w_bytes = k * cout // 2 if node.attrs["wfmt"] == "pot4" else k * cout
    return x_bytes + w_bytes + 8 * cout + y.numel(), 2.0 * macs


def _conv_plan(node, params, x_q):
    """The conv kernel's launch plan for a qconv2d node's input, or None
    where the node is a GEMM (1x1 stride 1) or no conv."""
    from tf2_tpu_torch.kernels import qconv

    if node.op != "qconv2d" or node.attrs.get("wfmt") == "wpack2":
        return None
    kshape = tuple(node.attrs["kshape"])
    strides = tuple(node.attrs.get("strides", (1, 1)))
    if kshape[:2] + strides == (1, 1, 1, 1):
        return None
    padding = node.attrs.get("padding", "SAME")
    if not isinstance(padding, str):
        padding = [tuple(p) for p in padding]
    pads = qconv.resolve_pads(padding, *kshape[:2], *strides, x_q.shape[1], x_q.shape[2])
    return qconv.launch_plan(x_q, params[node.params[0]], strides=strides, kshape=kshape,
                             pads=pads, wfmt=node.attrs["wfmt"])


def _taps(size: int, k: int, s: int, p0: int, out: int) -> tuple[int, int]:
    from tf2_tpu_torch.bench.conv_bound import taps

    return taps(size, k, s, p0, out)


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
    only as a time: torch._int_mm for GEMMs, bf16 F.conv2d for convs,
    F.local_response_norm on the dequantized f32 tensor (its NCHW view,
    alpha times the window so that its alpha / n is the node's alpha) for
    qlrn, F.scaled_dot_product_attention on the dequantized bf16 q, k, v
    (N, heads, T, hd) for qattention. No single PyTorch call computes a
    chain of bottleneck blocks: None."""
    import torch.nn.functional as F

    from tf2_tpu_torch.kernels import qconv
    from tf2_tpu_torch.transform import potq

    if node.op == "qblockchain":
        return None
    if node.op == "qattention_core":
        n, t, _ = x_q.shape
        heads, dim = node.attrs["heads"], node.attrs["dim"]
        q, k, v = ((z.to(torch.float32) * node.attrs["s_in"]).to(torch.bfloat16)
                   .reshape(n, t, heads, dim // heads).transpose(1, 2).contiguous()
                   for z in torch.split(x_q, dim, dim=-1))
        return lambda: F.scaled_dot_product_attention(q, k, v)
    if node.op == "qlrn":
        a = node.attrs
        size = 2 * a["radius"] + 1
        xf = (x_q.to(torch.float32) * a["s_in"]).permute(0, 3, 1, 2)
        return lambda: F.local_response_norm(xf, size, alpha=a["alpha"] * size,
                                             beta=a["beta"], k=a["bias"])
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
        x2 = _main_input(x_q).reshape(-1, node.attrs["kshape"][0])
        w2 = w if node.attrs["wfmt"] == "int8" else potq.pot_decode(
            potq.unpack_codes(w, node.attrs["kshape"][0]))
    return lambda: torch._int_mm(x2, w2)


def _adversarial(node, params, rng, x_q, extreme: bool):
    """+-127 inputs on weights of the largest magnitude (pot4 +-64, int8
    +-127). ``extreme``: every input +127 and every weight +max, the largest
    accumulator, with es placing it just inside the int8 range; otherwise
    random signs with es large enough that outputs clip at both ends. A
    residual is +-127 at random signs either way. Returns (params, x)."""
    if isinstance(x_q, tuple):
        p, x = _adversarial(node, params, rng, x_q[0], extreme)
        return p, (x, _random_pm127(rng, x_q[1]))
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


def _random_pm127(rng, like):
    return torch.as_tensor(rng.choice(np.array([127, -127], np.int8),
                                      size=tuple(like.shape))).to(like.device)


def _random_like(rng, x_q):
    """Random int8 of x_q's shape (each tensor of a pair)."""
    if isinstance(x_q, tuple):
        return tuple(_random_like(rng, x) for x in x_q)
    xv = rng.integers(-127, 128, tuple(x_q.shape), dtype=np.int8)
    return torch.as_tensor(xv).to(x_q.device)


def _ragged_cases(rng, dev):
    """Shapes off the main path: ragged M/N/K, cin 130, VALID padding; taps
    that cross a K step (C 24, 48, 96, 112, 144), copy widths 8 and 4, a
    K/2 not a multiple of 32, N 12 and 63 (SSD's heads), ResNet-50's stage 4
    at batch 1 (the smallest grid), the full 224x224 stem at batch 1, SSD's
    stem and a pot4 conv on 6 channels (the staged gather): together every
    variant the conv plan (kernels/qconv.py: plan) picks on the card."""
    from tf2_tpu_torch.graph import Node
    from tf2_tpu_torch.transform import potq

    cases = []
    for b, h, w, cin, cout, kk, s, pad, wfmt in [
            (2, 9, 9, 130, 40, 3, 1, "SAME", "pot4"),
            (2, 13, 13, 24, 32, 3, 2, "VALID", "int8"),
            (2, 15, 15, 32, 64, 3, 1, "SAME", "pot4"),
            (3, 7, 7, 48, 200, 1, 1, "SAME", "pot4"),
            (1, 28, 28, 3, 64, 7, 2, "SAME", "int8"),
            (2, 14, 14, 48, 64, 3, 1, "SAME", "pot4"),
            (2, 14, 14, 96, 128, 3, 1, "SAME", "pot4"),
            (2, 14, 14, 112, 224, 3, 1, "SAME", "pot4"),
            (2, 14, 14, 144, 288, 3, 1, "SAME", "pot4"),
            (2, 14, 14, 24, 64, 5, 1, "SAME", "pot4"),
            (2, 14, 14, 16, 48, 5, 1, "SAME", "pot4"),
            (2, 8, 8, 256, 12, 3, 1, "SAME", "pot4"),
            (2, 8, 8, 256, 63, 3, 1, "SAME", "pot4"),
            (2, 4, 4, 256, 63, 3, 1, "SAME", "int8"),
            (1, 7, 7, 512, 512, 3, 1, "SAME", "pot4"),
            (64, 28, 28, 128, 128, 3, 1, "SAME", "pot4"),
            (32, 28, 28, 64, 64, 3, 1, "SAME", "pot4"),
            (1, 224, 224, 3, 64, 7, 2, "SAME", "int8"),
            (1, 256, 256, 3, 32, 3, 2, "SAME", "int8"),
            (3, 11, 10, 6, 30, 3, 2, "SAME", "pot4")]:
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

    def raise_on_mismatch(self, what: str) -> None:
        if self.mismatches:
            raise RuntimeError(f"{what}:\n" + "\n".join(self.mismatches))

    def compare(self, kernel, node, params, x_q, what):
        return self.check(kernel, f"{node.name} {what}", _call(node, params, x_q),
                          _call(node, params, x_q, plain=True))

    def time(self, kernel, node, params, x_q, y, mult, total=True):
        """Time the node ``mult`` times a forward: a row of the per-shape
        table, and with ``total`` into the kernels line."""
        ms = cuda_ms(lambda: _call(node, params, x_q), 20)
        plain_ms = cuda_ms(lambda: _call(node, params, x_q, plain=True), 3)
        library = _library(node, params, x_q)
        library_ms = cuda_ms(library, 20) if library else None
        bytes_ms, ops_ms = _bound_ms(node, params, x_q, y)
        if node.op == "qblockchain":
            shape = {"blocks": len(node.attrs["blocks"]),
                     "cm": [blk["cm"] for blk in node.attrs["blocks"]]}
        elif node.op == "qlrn":
            shape = {"radius": node.attrs["radius"]}
        elif node.op == "qattention_core":
            shape = {"heads": node.attrs["heads"], "dim": node.attrs["dim"]}
        else:
            shape = {"kshape": node.attrs["kshape"], "strides": node.attrs.get("strides"),
                     "wfmt": node.attrs["wfmt"], "residual": isinstance(x_q, tuple)}
            plan = _conv_plan(node, params, _main_input(x_q))
            if plan is not None:
                shape["plan"] = plan.name
        self.add(kernel, {"node": node.name, "x": list(_main_input(x_q).shape), **shape},
                 ms, plain_ms, library_ms, bytes_ms, ops_ms, mult, total)

    def add(self, kernel, row, ms, plain_ms, library_ms, bytes_ms, ops_ms, mult, total=True):
        """A row of the per-shape table; with ``total``, ``mult`` times into
        the kernels line."""
        if total:
            s = self.k[kernel]
            s["ms"] += ms * mult
            s["plain_ms"] += plain_ms * mult
            s["library_ms"] = None if library_ms is None else s["library_ms"] + library_ms * mult
            s["bound_ms"] += max(bytes_ms, ops_ms) * mult
            s["bytes_bound_ms"] += bytes_ms * mult if bytes_ms >= ops_ms else 0.0
        self.rows.append({"kernel": kernel, "count": mult, **row, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bytes_ms": bytes_ms, "ops_ms": ops_ms})


def phase_kernels(engines, images, stats, timed: bool, total: bool = True):
    """Holds every conv and dense node of the engines' graphs against its
    plain version: on its real input (the plain path's value; with its
    residual, if it has one), with relu flipped on random inputs, and with
    +-127 inputs; one node of each distinct shape timed at batch 64 when
    ``timed`` (into the kernels line when ``total``). Returns the plain
    path's values of every node at each batch."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.kernels import dispatch

    rng = np.random.default_rng(1)
    plain_envs = {}
    for b, eng in engines.items():
        _, env = execute(eng.graph, intermediates=True, plain=True)(eng.params,
                                                                    image=images[b])
        plain_envs[b] = env
        groups: dict[str, list] = {}
        for node in eng.graph.nodes:
            if node.op not in ("qconv2d", "qdense") or node.attrs.get("wfmt") == "wpack2":
                continue  # the wpack2 stem: phase_stems
            x = env[node.inputs[0]]
            if "s_in" in node.attrs:
                x = dispatch.quantize(x, node.attrs["s_in"])
            if len(node.inputs) > 1:
                x = (x, env[node.inputs[1]])
            key = json.dumps([node.op, node.attrs["kshape"], node.attrs.get("strides"),
                              node.attrs.get("padding"), node.attrs["wfmt"],
                              list(_main_input(x).shape), isinstance(x, tuple)])
            groups.setdefault(key, []).append((node, x))
        for members in groups.values():
            node, x = members[0]
            kernel = _which_kernel(node, eng.params, x)
            for n, xm in members:
                y = stats.compare(kernel, n, eng.params, xm, f"b{b} main-path input")
            stats.compare(kernel, _flip_relu(node), eng.params, _random_like(rng, x),
                          f"b{b} random, relu flipped")
            for extreme in (True, False):
                p, xa = _adversarial(node, eng.params, rng, x, extreme)
                stats.compare(kernel, node, p, xa, f"b{b} +-127 extreme={extreme}")
            if timed and b == 64:
                stats.time(kernel, node, eng.params, x, y, len(members), total)
    stats.raise_on_mismatch("kernels disagree with their plain versions")
    return plain_envs


def phase_ragged_kernels(stats, dev):
    """The conv/GEMM kernels on shapes off the main paths."""
    rng = np.random.default_rng(4)
    variants = set()
    for node, params, x in _ragged_cases(rng, dev):
        kernel = _which_kernel(node, params, x)
        for n in (node, _flip_relu(node)):
            stats.compare(kernel, n, params, x, "ragged")
        plan = _conv_plan(node, params, x)
        if plan is not None:
            variants.add(plan.variant)
            log(f"ragged {node.name}: {plan.name}")
    stats.raise_on_mismatch("kernels disagree with their plain versions")
    log(f"ragged conv variants: {sorted(variants)}")
    log("kernels: " + ", ".join(f"{k} {v['checks']} checks max |err| {v['max_abs_err']}"
                                for k, v in stats.k.items()))


def phase_qlrn(engine_by_batch, plain_envs, stats):
    """Holds every qlrn node against ``qlrn_plain``: on its real input at
    each batch, then at the same shapes on random int8 inputs and on +-127
    inputs under each scale set of QLRN_SCALES at radius 1 and 2 and each
    beta of QLRN_BETAS, then on
    ragged shapes (odd pixel counts, C = 13, C < 2r + 1, one pixel); times
    each node at batch 64 (kernel, plain, bound, library)."""
    from tf2_tpu_torch.kernels import qlrn

    rng = np.random.default_rng(5)
    dev = next(iter(plain_envs[1].values())).device
    for b, eng in engine_by_batch.items():
        for node in (n for n in eng.graph.nodes if n.op == "qlrn"):
            x = plain_envs[b][node.inputs[0]]
            y = stats.compare("qlrn", node, eng.params, x, f"b{b} main-path input")
            inputs = {"random": rng.integers(-127, 128, tuple(x.shape), dtype=np.int8),
                      "+-127": rng.choice(np.array([-127, 127], np.int8), size=tuple(x.shape))}
            for what, xv in inputs.items():
                xr = torch.as_tensor(xv).to(dev)
                for (s_in, s_out, alpha), radius, beta in itertools.product(
                        QLRN_SCALES, (1, 2), QLRN_BETAS):
                    kw = dict(radius=radius, alpha=alpha, beta=beta, bias=1.0,
                              s_in=s_in, s_out=s_out)
                    stats.check("qlrn", f"{node.name} b{b} {what} {kw}",
                                qlrn.qlrn(xr, **kw), qlrn.qlrn_plain(xr, **kw))
            if b == 64:
                stats.time("qlrn", node, eng.params, x, y, 1)
            else:
                log(f"qlrn {node.name} b{b}: "
                    f"{cuda_ms(lambda: _call(node, eng.params, x), 20):.6f} ms")
    for m, c, radius in [(3137, 64, 2), (1001, 192, 1), (777, 13, 2), (5, 3, 2), (1, 192, 2)]:
        xr = torch.as_tensor(rng.integers(-127, 128, (m, c), dtype=np.int8)).to(dev)
        for (s_in, s_out, alpha), beta in itertools.product(QLRN_SCALES, QLRN_BETAS):
            kw = dict(radius=radius, alpha=alpha, beta=beta, bias=1.0, s_in=s_in, s_out=s_out)
            stats.check("qlrn", f"ragged {m}x{c} {kw}", qlrn.qlrn(xr, **kw),
                        qlrn.qlrn_plain(xr, **kw))
    stats.raise_on_mismatch("the qlrn kernel disagrees with its plain version")
    log(f"qlrn: {stats.k['qlrn']['checks']} checks, max |err| {stats.k['qlrn']['max_abs_err']}")


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
    stats.raise_on_mismatch("the chain kernel disagrees with the plain chain")
    log(f"chains: {stats.k['qblockchain']['checks']} checks, max |err| "
        f"{stats.k['qblockchain']['max_abs_err']}")
    return plain_envs


def phase_main(label, engines, cpu_engine, images, plain_envs, expected, same_as=None,
               out_shape=(1000,)):
    """A path through Engine.run: launch counts per forward must equal
    ``expected``; returns (launches per b64 forward, summary, outputs by
    batch). The outputs must be finite, (B, *out_shape). At batch 1 every
    node and the outputs must also equal the Engine on the CPU, whose plain
    path the CPU tests hold against tf2_tpu; with ``same_as`` the outputs
    must equal those bit for bit."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.graph import execute

    summary, launches, all_logits = {}, None, {}
    for b, eng in engines.items():
        kernels.reset_launch_counts()
        logits = eng.run(image=images[b])
        counts = kernels.launch_counts()
        if counts != expected:
            raise RuntimeError(f"{label} b{b}: launches per forward {counts}, "
                               f"expected {expected}")
        if b == 64:
            launches = counts
        all_logits[b] = logits
        if (tuple(logits.shape) != (len(images[b]), *out_shape)
                or not bool(torch.isfinite(logits).all())):
            raise RuntimeError(f"{label} b{b}: outputs {tuple(logits.shape)} "
                               f"not finite (B, {out_shape})")
        if same_as is not None and not torch.equal(logits, same_as[b]):
            raise RuntimeError(f"{label} b{b}: logits differ from the default Engine's")
        _, env = execute(eng.graph, intermediates=True, plain_nodes=eng.plain_nodes)(
            eng.params, image=images[b])
        differ = [n.name for n in eng.graph.nodes
                  if not torch.equal(env[n.name], plain_envs[b][n.name])]
        if differ or not torch.equal(logits, plain_envs[b][eng.graph.outputs[0]]):
            raise RuntimeError(f"{label} b{b}: nodes differ from the plain path: {differ[:5]}")
        if b == 1:
            t = time.time()
            cpu_logits, cpu_env = execute(cpu_engine.graph, intermediates=True)(
                cpu_engine.params, image=images[b].cpu())
            differ = [n.name for n in eng.graph.nodes
                      if not torch.equal(env[n.name].cpu(), cpu_env[n.name])]
            if differ or not torch.equal(logits.cpu(), cpu_logits):
                raise RuntimeError(f"{label} b1: nodes differ from the Engine on the CPU: "
                                   f"{differ[:5]}")
            log(f"{label} b1: {len(eng.graph.nodes)} nodes equal the Engine on the CPU "
                f"({time.time() - t:.1f} s on the CPU)")
        bench = eng.benchmark(iters=20 if b == 64 else 100, reps=3, image=images[b])
        summary[f"b{b}"] = {"img_per_s": bench["throughput_per_s"],
                            "latency_ms": bench["latency_s"] * 1e3,
                            "per_rep_ms": [t * 1e3 for t in bench["per_rep_s"]],
                            "nodes_checked": len(eng.graph.nodes),
                            "logits_absmax": float(logits.abs().max())}
        log(f"{label} b{b}: {counts}, {len(eng.graph.nodes)} nodes equal the plain path, "
            f"{bench['throughput_per_s']:.1f} img/s, {bench['latency_s'] * 1e3:.3f} ms/forward")
    return launches, summary, all_logits


def phase_zoo(name, images, stats):
    """Phases 8 and 9: the model's artifact and Engines, default and with
    merge_1x1=True; every conv and dense node of both graphs against its
    plain version (untimed: the kernels line times them on ResNet-50's
    path); GoogLeNet's qlrn nodes (phase_qlrn); the stem routes
    (phase_stems); both Engines through phase_main, the merged logits
    equal to the default's bit for bit. Returns (launches per b64 forward
    of the default Engine, summary)."""
    engines, cpu_engines = phase_artifact(name, ZOO_OPTIONS)
    envs = phase_kernels(engines["default"], images, stats, timed=False)
    if any(n.op == "qlrn" for n in engines["default"][64].graph.nodes):
        phase_qlrn(engines["default"], envs, stats)
    _, routes = phase_stems(name, engines["default"], cpu_engines["default"], images, stats)
    launches, summary, logits = phase_main(name, engines["default"], cpu_engines["default"],
                                           images, envs, ZOO_LAUNCHES[name]["default"])
    summary["stem_routes"] = routes
    merged_envs = phase_kernels(engines["merge_1x1"], images, stats, timed=False)
    _, summary["merge_1x1"], _ = phase_main(f"{name} merge_1x1", engines["merge_1x1"],
                                            cpu_engines["merge_1x1"], images, merged_envs,
                                            ZOO_LAUNCHES[name]["merge_1x1"], same_as=logits)
    log(f"{name}: kernels " + ", ".join(f"{k} {v['checks']} checks" for k, v in stats.k.items()))
    return launches, summary


def vit_artifact(name: str, image: int = 224):
    """Full-width ViT-B/16 at W8: the synthetic artifact's recipe
    (``models.synthetic_quantized``), with the position embedding, the class
    token and every layer norm's scale and offset drawn from a seeded
    generator (init_params leaves them at 0 and 1), so that qbias_add, the
    class token and the layer norms' affine do real work."""
    from tf2_tpu_torch.graph import init_params
    from tf2_tpu_torch.graph.optimize import patchify_stem
    from tf2_tpu_torch.models import SYNTHETIC_ACT_SCALE, get_model
    from tf2_tpu_torch.transform import QuantSpec, fold_batch_norm, quantize_graph

    g = get_model(name, batch=64, image=image, classes=1000)
    params = init_params(g, seed=0)
    rng = np.random.default_rng(3)
    for k, v in sorted(params.items()):
        if k in ("pos_embed", "cls_token"):
            params[k] = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(".scale"):
            params[k] = (1 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(".offset"):
            params[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    fg, fp = patchify_stem(*fold_batch_norm(g, params))
    scales = dict.fromkeys(list(fg.inputs) + [n.name for n in fg.nodes], SYNTHETIC_ACT_SCALE)
    return quantize_graph(fg, fp, scales, QuantSpec(weight_bits=8))


def phase_vit_artifact(name: str, image: int = 224, batches=(64, 1)):
    """The ViT artifact, saved and loaded back; Engines at ``batches`` and
    on the CPU at batch 1. -> (engines[batch], cpu_engine)."""
    from tf2_tpu_torch.transform import load_artifact, save_artifact

    t = time.time()
    art = vit_artifact(name, image)
    with tempfile.TemporaryDirectory() as d:
        save_artifact(d, art.graph, art.params)
        graph, params = load_artifact(d)
    if graph.to_json() != art.graph.to_json():
        raise RuntimeError(f"{name}: artifact round trip changed the graph")
    for k, v in art.params.items():
        if not np.array_equal(params[k], v):
            raise RuntimeError(f"{name}: artifact round trip changed {k}")
    engines, cpu_engines = make_engines(graph, params, {"default": {}}, batches)
    engines, cpu_engine = engines["default"], cpu_engines["default"]
    log(f"artifact {name} {image}x{image}: {len(params)} tensors, "
        f"{art.size_bytes() / 1e6:.1f} MB, "
        f"transform + save + load + engines {time.time() - t:.1f} s")
    return engines, cpu_engine


def _attention_node(node, s_in, s_out):
    from tf2_tpu_torch.graph import Node

    return Node(node.name, node.op, node.inputs, node.params,
                dict(node.attrs, s_in=s_in, s_out=s_out))


def phase_qattention(engines, plain_envs, stats, timed: bool, ragged: bool = True):
    """Holds every qattention_core node against ``qattention_plain``: on its
    real input at each batch, then at the same shape on random qkv under
    each pair of ATTN_SCALES and on +-127 inputs, then, with ``ragged``, on
    ragged (N, T, heads, hd); times the kernel at batch 64 when ``timed``
    (the first node, times the nodes a forward: they share the shape)."""
    from tf2_tpu_torch.graph import Node

    rng = np.random.default_rng(6)
    dev = next(iter(plain_envs[1].values())).device
    for b, eng in engines.items():
        nodes = [n for n in eng.graph.nodes if n.op == "qattention_core"]
        for node in nodes:
            x = plain_envs[b][node.inputs[0]]
            stats.compare("qattention", node, eng.params, x, f"b{b} main-path input")
            for s_in, s_out in ATTN_SCALES:
                stats.compare("qattention", _attention_node(node, s_in, s_out), eng.params,
                              _random_like(rng, x), f"b{b} random s_in {s_in} s_out {s_out}")
            stats.compare("qattention", node, eng.params, _random_pm127(rng, x), f"b{b} +-127")
        x = plain_envs[b][nodes[0].inputs[0]]
        if b == 64 and timed:
            stats.time("qattention", nodes[0], eng.params, x, None, len(nodes))
        elif b == 1:
            log(f"qattention {nodes[0].name} b1: "
                f"{cuda_ms(lambda: _call(nodes[0], eng.params, x), 20):.6f} ms")
    for n, t, heads, hd in [(3, 50, 4, 64), (2, 17, 4, 16), (1, 1, 12, 64), (5, 197, 12, 64),
                            (1, 481, 2, 64), (2, 577, 12, 64), (1, 1025, 2, 128),
                            (1, 4096, 2, 64)] if ragged else []:
        node = Node(f"ragged_{n}x{t}x{heads}x{hd}", "qattention_core", ("qkv",), (),
                    {"heads": heads, "dim": heads * hd})
        qkv = rng.integers(-127, 128, (n, t, 3 * heads * hd), dtype=np.int8)
        qkv = torch.as_tensor(qkv).to(dev)
        for s_in, s_out in ATTN_SCALES:
            stats.compare("qattention", _attention_node(node, s_in, s_out), {}, qkv, "ragged")
    stats.raise_on_mismatch("the attention kernel disagrees with its plain version")
    log(f"qattention: {stats.k['qattention']['checks']} checks, max |err| "
        f"{stats.k['qattention']['max_abs_err']}")


def phase_vit(name, images, stats):
    """Phase 10 for one model: the artifact and Engines; every qdense node
    (with and without a residual) against its plain version, timed per
    shape outside the kernels line when the model is vit_b16; every
    qattention_core node (timed into the kernels line for vit_b16); both
    batches through phase_main. Returns (launches per b64 forward,
    summary)."""
    engines, cpu_engine = phase_vit_artifact(name)
    timed = name == "vit_b16"
    envs = phase_kernels(engines, images, stats, timed=timed, total=False)
    phase_qattention(engines, envs, stats, timed)
    launches, summary, _ = phase_main(name, engines, cpu_engine, images, envs, VIT_LAUNCHES)
    log(f"{name}: kernels " + ", ".join(f"{k} {v['checks']} checks" for k, v in stats.k.items()))
    return launches, summary


def phase_vit384(stats):
    """Phase 14: ViT-B/16 at 384x384 (vit_b16_cls, T = 577) at batch 8 and
    1 as phase 10, then the kernel at batch 64 on random qkv of its shape,
    timed beside its plain version, bf16 SDPA and the bound (a per-shape
    row, not in the kernels line). Returns the summary."""
    rng = np.random.default_rng(9)
    images = {b: torch.as_tensor(rng.standard_normal((b, 384, 384, 3), dtype=np.float32)).cuda()
              for b in (8, 1)}
    engines, cpu_engine = phase_vit_artifact("vit_b16_cls", image=384, batches=(8, 1))
    envs = phase_kernels(engines, images, stats, timed=False)
    phase_qattention(engines, envs, stats, timed=False, ragged=False)
    _, summary, _ = phase_main("vit_b16_cls 384", engines, cpu_engine, images, envs,
                               VIT_LAUNCHES)
    node = next(n for n in engines[1].graph.nodes if n.op == "qattention_core")
    qkv = torch.as_tensor(rng.integers(-127, 128, (64, 577, 3 * node.attrs["dim"]),
                                       dtype=np.int8)).cuda()
    stats.compare("qattention", node, {}, qkv, "b64 384x384 random")
    stats.raise_on_mismatch("the attention kernel disagrees with its plain version")
    stats.time("qattention", node, {}, qkv, None, 12, total=False)
    summary["qattention_b64_row"] = stats.rows[-1]
    log(f"vit_b16_cls 384: qattention b64 {stats.rows[-1]['ms']:.6f} ms a launch")
    return summary


def phase_coverage():
    """Phase 15: the graphs of tf2_tpu_torch/bench/coverage_cases.py at
    batch 2 on the card: Engine.plain_nodes must be the nodes no kernel
    takes, and every node must equal Engine(device="cpu"). Returns the
    summary."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.bench import coverage_cases
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.runtime import Engine

    rng = np.random.default_rng(10)
    summary = {}
    for label, art, image, want in [
            ("convs", coverage_cases.conv_artifact(), 32, coverage_cases.CONV_PLAIN),
            ("vit_hd24", coverage_cases.tiny_vit_hd24(), 64, {"blk0_attn"})]:
        eng = Engine(art.graph, art.params)
        cpu = Engine(art.graph, art.params, device="cpu")
        log(f"coverage {label}: plain_nodes {sorted(eng.plain_nodes)}")
        if eng.plain_nodes != want:
            raise RuntimeError(f"coverage {label}: plain_nodes {sorted(eng.plain_nodes)}, "
                               f"expected {sorted(want)}")
        x = torch.as_tensor(rng.standard_normal((2, image, image, 3), dtype=np.float32))
        kernels.reset_launch_counts()
        logits, env = execute(eng.graph, intermediates=True, plain_nodes=eng.plain_nodes)(
            eng.params, image=x.cuda())
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        cpu_logits, cpu_env = execute(cpu.graph, intermediates=True)(cpu.params, image=x)
        differ = [n.name for n in eng.graph.nodes
                  if not torch.equal(env[n.name].cpu(), cpu_env[n.name])]
        if differ or not torch.equal(eng.run(image=x).cpu(), cpu_logits) or not counts:
            raise RuntimeError(f"coverage {label}: nodes differ from the CPU Engine: {differ}")
        log(f"coverage {label}: {len(eng.graph.nodes)} nodes equal the CPU Engine; "
            f"launches {counts}")
        summary[label] = {"plain_nodes": sorted(eng.plain_nodes), "launches": counts,
                          "nodes_checked": len(eng.graph.nodes)}
    return summary


def _stem_pieces(cpu_engine, dev):
    """The model's stem (its first conv: stride 2, cin 3, the input
    quantize fused in) and the other routes' nodes for it, from the CPU
    Engine's graph: the wpack2 node (pack_phase_stem) and the pad,
    space_to_depth and conv nodes of space_to_depth_stem (None where that
    pass skips the stem: SqueezeNet's VALID one). -> (stem, packed, packed
    params, s2d nodes, s2d conv params), params on ``dev``."""
    from tf2_tpu_torch.graph.optimize import pack_phase_stem, space_to_depth_stem

    params = {k: v.numpy() for k, v in cpu_engine.params.items()}
    stem = next(n for n in cpu_engine.graph.nodes if n.op == "qconv2d")
    pg, pp = pack_phase_stem(cpu_engine.graph, params)
    packed = pg.node_map()[stem.name]
    if packed.attrs.get("wfmt") != "wpack2":
        raise RuntimeError(f"{stem.name}: pack_phase_stem did not pack the stem")
    sg, sp = space_to_depth_stem(cpu_engine.graph, params)
    nodes = sg.node_map()
    s2d = [nodes[f"{stem.name}__s2d_pad"], nodes[f"{stem.name}__s2d"], nodes[stem.name]] \
        if f"{stem.name}__s2d" in nodes else None

    def on_dev(p, names):
        return {k: torch.as_tensor(p[k]).to(dev) for k in names}

    return (stem, packed, on_dev(pp, packed.params), s2d,
            on_dev(sp, s2d[2].params) if s2d else None)


def _stem_adversarial(rng, x_q, w_q, extreme: bool):
    """+-127 inputs on +-127 weights; ``extreme``: all +127, es placing the
    largest sum just inside the int8 range; otherwise random signs, es
    large enough that outputs clip at both ends. -> (x, w, es)."""
    kh, kw, cin, cout = w_q.shape
    k = kh * kw * cin
    if extreme:
        x, w = torch.full_like(x_q, 127), torch.full_like(w_q, 127)
        scale = rng.uniform(0.2, 0.99, cout)
    else:
        x, w = _random_pm127(rng, x_q), _random_pm127(rng, w_q)
        scale = rng.uniform(0.5, 8.0, cout) * np.sqrt(k)
    return x, w, torch.as_tensor((scale / (127 * k)).astype(np.float32)).to(x_q.device)


def _bf16_conv(x, w_q, strides, padding):
    """bf16 F.conv2d of ``x`` NHWC and HWIO ``w_q``, channels-last: a
    yardstick time only."""
    import torch.nn.functional as F

    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wb = w_q.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xb, wb, stride=strides, padding=padding)


def phase_stems(name, engines, cpu_engine, images, stats, timed=False):
    """Phase 12 for one model's stem, at batch 64 and 1. fused_qstem (the
    entry) on the f32 image and the stem's real weights, eff_scale,
    eff_bias and s_in, its launches counted from 0 (one, the qstem kernel);
    its output equal to the Engine's stem node (quantize + the stride-2 conv
    kernel) and to qstem_plain, then on the quantized int8 image, relu on
    and off, and +-127; the wpack2 node (the conv kernel's stride-(2, 1)
    entry) equal to the Engine's stem node and to its plain version, on
    random and +-127 packed inputs; the space_to_depth route equal to the
    Engine's stem node. Times the four routes (the whole node and its
    kernel alone) and bf16 F.conv2d; with ``timed`` (ResNet-50), qstem and
    the stride-(2, 1) conv at batch 64 into the kernels line. -> (launch
    counts of the b64 fused_qstem call, route times by batch)."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.graph.execute import _OP_IMPLS
    from tf2_tpu_torch.kernels import dispatch, qconv, qstem

    rng = np.random.default_rng(7)
    dev = images[1].device
    stem, packed, pparams, s2d, sparams = _stem_pieces(cpu_engine, dev)
    kh, kw, cin, cout = stem.attrs["kshape"]
    s_in, relu, padding = stem.attrs["s_in"], stem.attrs["relu"], stem.attrs["padding"]
    pk = dict(kshape=tuple(packed.attrs["pack_kshape"]), wfmt="int8",
              pads=(tuple(packed.attrs["pack_pad_h"]), (0, 0)))
    wp = pparams[packed.params[0]]

    def s2d_route(x):
        pad, space, conv = s2d
        xs = _OP_IMPLS["space_to_depth"][0](space, {}, _OP_IMPLS["pad"][0](pad, {}, x))
        return dispatch.qconv2d(conv, sparams, xs)

    launches, routes = None, {}
    for b, eng in engines.items():
        x = images[b]
        w_q, es, eb = (eng.params[p] for p in stem.params)
        w_q = w_q.reshape(kh, kw, cin, cout)
        kernels.reset_launch_counts()
        y = qstem.fused_qstem(x, w_q, es, eb, padding=padding, relu=relu, scale=s_in)
        counts = kernels.launch_counts()
        if counts != {**dict.fromkeys(counts, 0), "qstem": 1}:
            raise RuntimeError(f"{name} b{b}: fused_qstem launched {counts}")
        launches = counts if b == 64 else launches
        want = dispatch.qconv2d(stem, eng.params, x)  # the Engine's stem node
        stats.check("qstem", f"{name} b{b} against the Engine's stem node", y, want)
        x_q = dispatch.quantize(x, s_in)
        for r, (xin, scale) in itertools.product((relu, not relu), ((x, s_in), (x_q, None))):
            kw_ = dict(padding=padding, relu=r, scale=scale)
            stats.check("qstem", f"{name} b{b} relu={r} scale={scale}",
                        qstem.fused_qstem(xin, w_q, es, eb, **kw_),
                        qstem.fused_qstem(xin, w_q, es, eb, plain=True, **kw_))
        for extreme in (True, False):
            xa, wa, esa = _stem_adversarial(rng, x_q, w_q, extreme)
            kw_ = dict(padding=padding, relu=relu)
            stats.check("qstem", f"{name} b{b} +-127 extreme={extreme}",
                        qstem.fused_qstem(xa, wa, esa, eb, **kw_),
                        qstem.fused_qstem(xa, wa, esa, eb, plain=True, **kw_))
        # the wpack2 stem and its stride-(2, 1) conv
        y2 = dispatch.qconv2d(packed, pparams, x)
        stats.check("qconv_s2x1", f"{name} b{b} wpack2 against the Engine's stem node", y2, want)
        stats.check("qconv_s2x1", f"{name} b{b} wpack2 node", y2,
                    dispatch.qconv2d(packed, pparams, x, plain=True))
        xp = dispatch.pack_w_pairs(x_q, packed.attrs["pack_pad_w"])
        xr = _random_like(rng, xp)
        stats.check("qconv_s2x1", f"{name} b{b} random, relu flipped",
                    qconv.qconv_s2x1(xr, wp, es, eb, relu=not relu, **pk),
                    qconv.qconv_plain(xr, wp, es, eb, strides=(2, 1), relu=not relu, **pk))
        for extreme in (True, False):
            xa, wa, esa = _stem_adversarial(rng, xp, wp, extreme)
            stats.check("qconv_s2x1", f"{name} b{b} +-127 extreme={extreme}",
                        qconv.qconv_s2x1(xa, wa, esa, eb, relu=relu, **pk),
                        qconv.qconv_plain(xa, wa, esa, eb, strides=(2, 1), relu=relu, **pk))
        if s2d:
            stats.check("qconv_s1", f"{name} b{b} space_to_depth against the Engine's stem node",
                        s2d_route(x), want)
        # the routes side by side: the whole stem node, and its kernel alone
        n = 20 if b == 64 else 100
        pads = qconv.resolve_pads(padding, kh, kw, 2, 2, x.shape[1], x.shape[2])
        wmat = qstem.fold_weight(w_q)
        r = {"conv_s2": (lambda: dispatch.qconv2d(stem, eng.params, x),
                         lambda: qconv.qconv_s2(x_q, w_q, es, eb, kshape=(kh, kw, cin, cout),
                                                pads=pads, relu=relu, wfmt="int8")),
             "wpack2": (lambda: dispatch.qconv2d(packed, pparams, x),
                        lambda: qconv.qconv_s2x1(xp, wp, es, eb, relu=relu, **pk)),
             "qstem": (lambda: qstem.fused_qstem(x, w_q, es, eb, padding=padding, relu=relu,
                                                 scale=s_in),
                       lambda: qstem.qstem(x, wmat, es, eb, kh=kh, kw=kw, padding=padding,
                                           relu=relu, scale=s_in))}
        if s2d:
            conv = s2d[2]
            xs_q = dispatch.quantize(_OP_IMPLS["space_to_depth"][0](
                s2d[1], {}, _OP_IMPLS["pad"][0](s2d[0], {}, x)), s_in)
            r["space_to_depth"] = (lambda: s2d_route(x), lambda: qconv.qconv_s1(
                xs_q, sparams[conv.params[0]], es, eb, kshape=tuple(conv.attrs["kshape"]),
                pads=((0, 0), (0, 0)), relu=relu, wfmt="int8"))
        routes[f"b{b}"] = {k: {"node_ms": cuda_ms(node_fn, n), "kernel_ms": cuda_ms(kernel_fn, n)}
                           for k, (node_fn, kernel_fn) in r.items()}
        routes[f"b{b}"]["bf16_conv2d_ms"] = cuda_ms(_bf16_conv(
            x, w_q, 2, kh // 2 if padding == "SAME" else 0), n)
        routes[f"b{b}"]["bytes_bound_ms"] = (x.numel() * 4 + y.numel()) / H100_BYTES_PER_S * 1e3
        log(f"{name} stem routes b{b}: {json.dumps(routes[f'b{b}'])}")
        if timed and b == 64:
            _time_stem_kernels(stats, x, wmat, w_q, es, eb, y, stem, xp, wp, pk, y2)
    stats.raise_on_mismatch(f"{name}: the stem kernels disagree with their plain versions")
    return launches, routes


def _time_stem_kernels(stats, x, wmat, w_q, es, eb, y, stem, xp, wp, pk, y2):
    """qstem and the stride-(2, 1) conv at the ResNet-50 b64 stem into the
    kernels line (one launch a forward each), beside their plain versions,
    bf16 F.conv2d and their bounds: qstem reads the f32 image, the folded
    weight, es and eb once and writes the int8 output once, 2 operations a
    multiply-accumulate inside the image; the packed conv reads the packed
    int8 image (its W pads included) instead."""
    from tf2_tpu_torch.kernels import qconv, qstem

    kh, kw, cin, cout = stem.attrs["kshape"]
    s_in, relu, padding = stem.attrs["s_in"], stem.attrs["relu"], stem.attrs["padding"]
    b, h, w, _ = x.shape
    (ph0, _), (pw0, _) = qconv.resolve_pads(padding, kh, kw, 2, 2, h, w)
    _, taps_y = _taps(h, kh, 2, ph0, y.shape[1])
    _, taps_x = _taps(w, kw, 2, pw0, y.shape[2])
    kwq = dict(kh=kh, kw=kw, padding=padding, relu=relu, scale=s_in)
    stats.add("qstem", {"node": stem.name, "x": list(x.shape), "kshape": [kh, kw, cin, cout]},
              cuda_ms(lambda: qstem.qstem(x, wmat, es, eb, **kwq), 20),
              cuda_ms(lambda: qstem.qstem_plain(x, wmat, es, eb, **kwq), 3),
              cuda_ms(_bf16_conv(x, w_q, 2, kh // 2 if padding == "SAME" else 0), 20),
              (x.numel() * 4 + wmat.numel() + 8 * cout + y.numel()) / H100_BYTES_PER_S * 1e3,
              2.0 * b * taps_y * taps_x * cin * cout / H100_INT8_OPS_PER_S * 1e3, 1)
    pkh, pkw, pcin, _ = pk["kshape"]
    (lo_h, _), _ = pk["pads"]
    _, taps_y = _taps(h, pkh, 2, lo_h, y2.shape[1])
    _, taps_x = _taps(xp.shape[2], pkw, 1, 0, y2.shape[2])
    stats.add("qconv_s2x1", {"node": stem.name, "x": list(xp.shape), "kshape": list(pk["kshape"]),
                             "strides": [2, 1], "wfmt": "int8"},
              cuda_ms(lambda: qconv.qconv_s2x1(xp, wp, es, eb, relu=relu, **pk), 20),
              cuda_ms(lambda: qconv.qconv_plain(xp, wp, es, eb, strides=(2, 1), relu=relu, **pk), 3),
              cuda_ms(_bf16_conv(xp, wp, (2, 1), (lo_h, 0)), 20),
              (xp.numel() + wp.numel() + 8 * cout + y2.numel()) / H100_BYTES_PER_S * 1e3,
              2.0 * b * taps_y * taps_x * pcin * cout / H100_INT8_OPS_PER_S * 1e3, 1)


def phase_ragged_stems(stats, dev):
    """The stem kernel off the zoo's shapes (k 5 and 1, odd H and W, cin 1,
    2 and 4, cout 130, batch 3) on f32 and int8 input, relu on and off; the
    stride-(2, 1) conv on ragged packed inputs."""
    from tf2_tpu_torch.kernels import qconv, qstem

    rng = np.random.default_rng(9)
    for b, h, w, cin, cout, k, padding in RAGGED_STEMS:
        w_q = torch.as_tensor(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).to(dev)
        es = torch.as_tensor((rng.uniform(0.5, 4.0, cout) / (127 * np.sqrt(k * k * cin)))
                             .astype(np.float32)).to(dev)
        eb = torch.as_tensor(rng.normal(0, 20, cout).astype(np.float32)).to(dev)
        xf = torch.as_tensor(rng.standard_normal((b, h, w, cin), dtype=np.float32)).to(dev)
        xq = torch.as_tensor(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(dev)
        for relu, (xin, scale) in itertools.product((False, True), ((xf, 0.013), (xq, None))):
            kw_ = dict(padding=padding, relu=relu, scale=scale)
            stats.check("qstem", f"ragged {b}x{h}x{w}x{cin} k{k} {padding} -> {cout} {kw_}",
                        qstem.fused_qstem(xin, w_q, es, eb, **kw_),
                        qstem.fused_qstem(xin, w_q, es, eb, plain=True, **kw_))
    for b, h, w, cin, cout, kh, kw, pads in [(3, 17, 9, 2, 40, 5, 3, ((2, 2), (0, 0))),
                                             (2, 63, 32, 6, 64, 3, 2, ((0, 0), (0, 0))),
                                             (1, 31, 16, 8, 72, 7, 4, ((3, 3), (0, 0)))]:
        x = torch.as_tensor(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(dev)
        wq = torch.as_tensor(rng.integers(-127, 128, (kh, kw, cin, cout), dtype=np.int8)).to(dev)
        es = torch.as_tensor(rng.uniform(1e-5, 1e-3, cout).astype(np.float32)).to(dev)
        eb = torch.as_tensor(rng.standard_normal(cout).astype(np.float32)).to(dev)
        for relu in (False, True):
            kw_ = dict(kshape=(kh, kw, cin, cout), pads=pads, relu=relu, wfmt="int8")
            stats.check("qconv_s2x1", f"ragged {b}x{h}x{w}x{cin} {kh}x{kw} relu={relu}",
                        qconv.qconv_s2x1(x, wq, es, eb, **kw_),
                        qconv.qconv_plain(x, wq, es, eb, strides=(2, 1), **kw_))
    stats.raise_on_mismatch("the stem kernels disagree with their plain versions off the zoo")
    log(f"stems: qstem {stats.k['qstem']['checks']} checks, qconv_s2x1 "
        f"{stats.k['qconv_s2x1']['checks']} checks")


def phase_ssd(stats):
    """Phase 13: full-width SSD (256x256, 21 classes, 1,008 priors, W4-PoT)
    under both score cases (tf2_tpu_torch/bench/ssd_cases.py): the artifact
    round trip, Engines at batch 64 and 1 and on the CPU at batch 1; every
    conv node against its plain version; the stem routes (phase_stems);
    phase_main with (B, 100, 6) detections. Returns the summary."""
    from tf2_tpu_torch.bench.ssd_cases import CASES, case_params

    t = time.time()
    graph, params, mb = load_round_trip("ssd", image=256, classes=21)
    log(f"artifact ssd: {len(params)} tensors, {mb:.1f} MB, transform + save + load "
        f"{time.time() - t:.1f} s")
    rng = np.random.default_rng(8)
    images = {b: torch.as_tensor(rng.standard_normal((b, 256, 256, 3), dtype=np.float32)).cuda()
              for b in (64, 1)}
    summary = {}
    for case in CASES:
        engines, cpu_engines = make_engines(graph, case_params(case, graph, params),
                                            {"default": {}})
        envs = phase_kernels(engines["default"], images, stats, timed=False)
        if case == CASES[0]:
            _, summary["stem_routes"] = phase_stems("ssd", engines["default"],
                                                    cpu_engines["default"], images, stats)
        _, summary[case], dets = phase_main(f"ssd {case}", engines["default"],
                                            cpu_engines["default"], images, envs, SSD_LAUNCHES,
                                            out_shape=(100, 6))
        summary[case]["kept_per_image_b64"] = float((dets[64][..., 4] > 0).sum()) / 64
        log(f"ssd {case}: {summary[case]['kept_per_image_b64']:.2f} detections an image kept")
    return summary


def main() -> int:
    t0 = time.time()
    smi = phase_card()
    phase_build()
    engines, cpu_engines = phase_artifact("resnet50", RESNET_OPTIONS, depths=(3, 4, 6, 3))
    rng = np.random.default_rng(0)
    images = {b: torch.as_tensor(rng.standard_normal(
        (b, 224, 224, 3), dtype=np.float32)).cuda() for b in (64, 1)}
    stats = KernelStats()
    plain_envs = phase_kernels(engines["default"], images, stats, timed=True)
    phase_ragged_kernels(stats, images[1].device)
    launches, summary, logits = phase_main("resnet50", engines["default"],
                                           cpu_engines["default"], images, plain_envs,
                                           EXPECTED_LAUNCHES)
    fused_envs = phase_chains(engines["block_fusion"], images, stats)
    fused_launches, summary["block_fusion"], _ = phase_main(
        "resnet50 block_fusion", engines["block_fusion"], cpu_engines["block_fusion"], images,
        fused_envs, FUSED_LAUNCHES, same_as=logits)
    launches["qblockchain"] = fused_launches["qblockchain"]
    for option in ("phase_stem", "optimize"):
        envs = phase_kernels(engines[option], images, stats, timed=False)
        option_launches, summary[option], _ = phase_main(
            f"resnet50 {option}", engines[option], cpu_engines[option], images, envs,
            STEM_LAUNCHES[option], same_as=logits)
        if option == "phase_stem":
            launches["qconv_s2x1"] = option_launches["qconv_s2x1"]
    stem_launches, summary["stem_routes"] = phase_stems(
        "resnet50", engines["default"], cpu_engines["default"], images, stats, timed=True)
    launches["qstem"] = stem_launches["qstem"]
    phase_ragged_stems(stats, images[1].device)
    del engines, cpu_engines, plain_envs, fused_envs, envs
    zoo = {}
    for name in ZOO_LAUNCHES:
        zoo_launches, zoo[name] = phase_zoo(name, images, stats)
        if name == "googlenet":
            launches["qlrn"] = zoo_launches["qlrn"]
    for name in ("vit_b16", "vit_b16_cls"):
        vit_launches, zoo[name] = phase_vit(name, images, stats)
        if name == "vit_b16":
            launches["qattention"] = vit_launches["qattention"]
    zoo["ssd"] = phase_ssd(stats)
    zoo["vit_b16_cls_384"] = phase_vit384(stats)
    zoo["coverage"] = phase_coverage()
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
    wall_s = time.time() - t0
    log(f"wall time {wall_s:.1f} s")
    print(json.dumps({"main_path": summary, **zoo, "card": smi, "wall_s": wall_s}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
