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
             the CPU at batch 1: block_fusion=False, the default (its
             bottleneck chains fused), phase_stem=True and optimize=True
             (both unfused). Each Engine follows the committed routing
             table (phase 17).
 4. kernels  each of the conv/GEMM kernels against its plain version
             on the card with 0 mismatches: every conv/dense node of the path
             at batch 64 and 1 on its real input, the same shapes with relu
             flipped on random inputs and with +-127 inputs on
             max-magnitude weights, and ragged shapes that with the zoo's
             reach every variant of the conv plan (each printed); ragged
             int8 GEMMs (RAGGED_GEMMS) with the weight prepared K-major
             and given as it is (prepared on the call, counted), which with
             the zoo's shapes (phases 4-10) reach every variant of the int8
             GEMM's plan (tiles, split-K, copy widths, residual; each
             printed, all required after phase 10); ragged pot4 GEMMs
             (RAGGED_POT4) the same way, random and +-127 inputs on
             max-magnitude codes, which with the zoo's shapes (phases 4-9)
             reach every variant of the pot4 plan (BM, BN, copy widths, slab
             and wave splits; each printed, all required after phase 10).
             Times each
             kernel (a conv's row names the plan it took),
             its plain version and a library yardstick (torch._int_mm for
             the GEMMs, bf16 F.conv2d for the convs) with CUDA events at
             the batch-64 shapes.
 5. unfused  Engine(block_fusion=False).run at batch 64 and 1 with launch
             counts per forward (33 / 1 / 13 / 6 / 0 / 0 / 0 / 0 / 1: the
             stem on qstem; moved by the routes), no
             weight prepared on the forward (every Engine here: the int8
             GEMMs', chains' and stems' weights are in their kernels'
             layouts from the load), finite (B, 1000) logits,
             every node equal to the plain path on the card and, at batch 1,
             to the Engine on the CPU; Engine.benchmark img/s and latency.
 6. chains   the default Engine (block_fusion) at batch 64 and 1 from the same
             artifact: every conv and dense node (the six pot4 GEMMs
             between the chains) as in phase 4, untimed; every qblockchain
             node against the plain chain with
             0 mismatches on its real input, with the adds' relu flipped,
             with +-127 inputs on +-127 weights, and ragged chains on the
             plans the wrapper picks; two-block chains on every kind of
             plan given to it (GIVEN_CHAIN_PLANS: bands and whole images,
             clusters of 1-16 CTAs, G > 1, MMA widths 32 and 64, narrow
             bands, ragged channels), relu on and off and +-127; the plans
             taken printed, every kind required; each chain timed at batch
             64 (kernel, plain, bound) and its kernel at batch 1.
 7. fused    the default Engine's run at batch 64 and 1, the main path:
             launch counts per forward (6 / 1 / 0 / 6 / 4 / 0 / 0 / 0 / 1,
             moved by its routes: routed_launches), every node
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
             C = 13, C < 2r + 1, M = 1), and with y / s_out on and next to
             every .5 boundary (the elements the certified epilogue sends to
             the exact steps counted and printed, at least one required),
             all with 0 mismatches; qlrn timed
             at batch 64 (kernel, plain, bound, F.local_response_norm as
             the yardstick); its stem as in phase 12. Then both Engines as
             in phase 5: launch counts per forward
             (37 / 1 / 19 / 0 / 0 / 2 / 0 / 0 / 1 default,
             10 / 10 / 19 / 0 / 0 / 2 / 0 / 0 / 1 merged), every node equal
             to the plain path and at batch 1 to the CPU Engine, merged
             logits equal to the default's bit for bit, Engine.benchmark.
 9. squeezenet  the same for SqueezeNet v1.1, which has no LRN: launch
             counts 16 / 1 / 8 / 0 / 0 / 0 / 0 / 0 / 1 default and
             12 / 1 / 8 / 0 / 0 / 0 / 0 / 0 / 1 merged (fires 2-5 merge
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
             and 13) at batch 64 and 1: the Engine's stem node (routed at
             load to qstem, its weight prepared) on the f32 image, its
             launches counted from 0 (one qstem launch, nothing prepared),
             equal to qstem_plain and to the two-pass route (quantize +
             qconv_s2, called directly); fused_qstem on the prepared and
             the HWIO weight, on the f32 image and the int8 image with
             -128 in it, relu on and off, and +-127; the wpack2 node (the
             conv kernel's stride-(2, 1) entry) equal to the stem node and
             to its plain version, on random and +-127 packed inputs; the
             space-to-depth route equal to the stem node. The four routes
             timed side by side (the whole stem node and its kernel alone)
             beside bf16 F.conv2d and the byte bound; qstem and the
             stride-(2, 1) conv timed at ResNet-50's b64 stem into the
             kernels line. Then the ragged stems (RAGGED_STEMS: k 1-7, odd
             H and W, cin 1-4, cout 8-256, VALID and SAME, the copy tails),
             prepared and not, and ragged packed convs. Then the stems the
             kernel's plan has no launch for (k 9, cout 288): fused_qstem
             on the quantize and the stride-2 conv kernel (counted in
             qstem.TWO_PASS) and an Engine whose stem stays outside its
             stem plan, equal to qstem_plain, eager and built.
13. ssd      full-width SSD (256x256, 21 classes, 1,008 priors, W4-PoT)
             under both score cases (random and background-dominated,
             tf2_tpu_torch/bench/ssd_cases.py): the artifact round trip,
             Engines at batch 64 and 1 and on the CPU at batch 1, every conv
             node against its plain version, its stem as in phase 12, then
             as in phase 5 with (B, 100, 6) detections: launch counts
             0 / 0 / 8 / 5 / 0 / 0 / 0 / 0 / 1, every node equal to the
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
16. captured after each path's eager phases, ResNet-50 (default,
             block_fusion=True, phase_stem=True), GoogLeNet, SqueezeNet and
             vit_b16 at batch 64 and 1: Engine.build (one eager forward,
             then one CUDA graph of the whole forward) must launch twice a
             forward's kernels (the wrappers count at capture); three
             replays on three seeded inputs equal the eager forward bit for
             bit and launch nothing through a wrapper; Engine.benchmark of
             the captured forward beside the eager one. ResNet-50's
             Engine(donate_inputs=True), built, equals the others, each
             donated input freed. SSD's build raises its reason (its NMS
             waits on the host).
17. routing  for each zoo CNN at batch 64 and 1: the committed routing
             table (tf2_tpu_torch/kernels/routing_defaults/) is the one
             loaded; the default Engine (routed by it) equals
             set_use_kernels(True)'s bit for bit, its routed nodes equal to
             their plain versions; Engines with every node that has the
             route on kernel_int8 and on library each equal the plain path
             node by node and set_use_kernels(True)'s logits.
18. headline the headline bench's line (tf2_tpu_torch/bench/headline.py)
             from phase 16's built ResNet-50 Engines.
19. transform the Transform Kit (tf2_tpu_torch/transform/) on the card,
             from FP32 weights (init_params(seed 0)) through the CLI
             (python -m tf2_tpu_torch.transform.cli, called as cli.main):
             ResNet-50 W4 at 224x224, 1000 classes, calibration batch 4, two
             batches, percentile, bias correction on: its JSON line and the
             seconds of each stage printed, and the launches its bias
             correction's replay made (qconv_s1, qconv_s2, qmatmul_pot4 and
             qmatmul_int8 each more than 0). Its artifact, hashes verified,
             on the block_fusion=False and default Engines at batch 64 and 1
             (plain_nodes empty) as phases 4, 5 and 7 (every conv and GEMM
             node against its plain version, launch counts, every node
             equal to the plain path and at batch 1 to the CPU Engine, the
             default's logits equal to the unfused ones), captured as phase
             16; the relative error and cosine of its logits against the
             folded FP32 forward (TF32 off) printed, not gated. The same CLI
             with --platform cpu and with --platform cuda at image 64, batch
             2 (full depth and width; the smaller image for the time limit):
             equal weight hashes, scales within 1e-5 and es within 3e-5
             relative, eb within 1e-3 output quanta, the largest of each
             printed. The CLI with --prune 0.3 at 224x224: both Engines with
             plain_nodes empty, every conv and GEMM node against its plain
             version. GoogLeNet, SqueezeNet v1.1 (W4), vit_b16 (--wbits 8)
             and SSD (21 classes, at its 256x256) at the CLI's defaults with
             one calibration batch: each artifact's Engine (plain_nodes empty) on its
             kernels equals the Engine with set_use_kernels(False). The f32
             graph of coverage_cases.fp32_ops_graph (batch_norm, attention,
             relu6, sigmoid, mul, SAME and VALID avgpool; dim 768, 12 heads,
             196 tokens) on the card against the CPU, TF32 off, every node
             within 1e-5 of its largest value. The phase's seconds printed.
20. serving (run after phase 18, on phase 16's built default ResNet-50
             Engines) the port's serving path (tf2_tpu_torch/serve/,
             tf2_tpu_torch/utils/preproc.py): native/preproc.cpp built with
             g++ into tf2_tpu_torch/utils/build/, against the numpy path at
             the reference test's cases and bars (f32 within 1e-4 at 37x53 ->
             32; int8 within one quantum and over 99% exact at 64x64 -> 48)
             and on 64 random 256x256 uint8 images to 224x224 (int8 at that
             bar, f32 within preproc.f32_error_bound); PrefetchLoader (depth 2)
             feeding four such batches to the built b64 Engine, each forward
             equal to the eager one; InferenceServer(batch 64) + serve_http
             (port 0): 256 requests from 32 threads and 16 over POST
             /predict, each response equal bit for bit to its row of a
             direct forward, start()'s build launching twice a forward's
             kernels and the replays none, /healthz, /stats (requests,
             captured) and 400 on a malformed body; InferenceServer(batch
             1): 64 sequential requests, each equal; SSD (256x256, b8) served
             uncaptured, every (100, 6) detection row equal, its launches
             those of its served batches; serving_load at b64 (24 clients, 4
             s) and b1 (4 clients, 2 s), engine_steady donate on and off (2
             s each, on phase 16's donated and default b64 Engines), the b64
             time split (serving_bench.time_split); the
             measured peaks (bench/peaks.py) beside the data sheet and
             ResNet-50 b64's roofline (bench/roofline.py) with both, its
             sol_fraction against phase 16's built ms; native/libtf2preproc.so
             unchanged. Every number printed with the card.
Every zoo Engine on the card (phases 3-14) must have empty plain_nodes:
the coverage plan sends none of the zoo's nodes to a plain version.
Launch counts are in the order (qmatmul_pot4, qmatmul_int8, qconv_s1,
qconv_s2, qblockchain, qlrn, qattention, qconv_s2x1, qstem). Prints the
headline bench's line, the summary line (every path's numbers, the stem
routes, the captured forwards, the routes, serving, the run's wall time),
the kernels JSON line (launches from the Engine each kernel was timed on:
the conv and GEMM kernels' from phase 5's unfused Engine, which runs every
conv (the default's chains take the 3x3s and most GEMMs, phase 7),
qblockchain's from phase 7, qconv_s2x1's from phase 11's phase_stem
Engine, qlrn's from phase 8, qattention's from phase 10, each entry's
launches_from naming the Engine; times at ResNet-50's
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
EXPECTED_LAUNCHES = _launches(33, 1, 13, 6, 0, 0, 0, 0, 1)
FUSED_LAUNCHES = _launches(6, 1, 0, 6, 4, 0, 0, 0, 1)
STEM_LAUNCHES = {"phase_stem": _launches(33, 1, 13, 6, 0, 0, 0, 1, 0),
                 "optimize": _launches(33, 1, 14, 6, 0, 0, 0, 0, 0)}
# the default Engine fuses the bottleneck chains (block_fusion, on by
# default since the card measured it); the others run every block's convs
RESNET_OPTIONS = {"unfused": {"block_fusion": False}, "default": {},
                  "phase_stem": {"phase_stem": True, "block_fusion": False},
                  "optimize": {"optimize": True, "block_fusion": False}}
ZOO_OPTIONS = {"default": {}, "merge_1x1": {"merge_1x1": True}}
ZOO_LAUNCHES = {  # model -> {option: launches}
    "googlenet": {"default": _launches(37, 1, 19, 0, 0, 2, 0, 0, 1),
                  "merge_1x1": _launches(10, 10, 19, 0, 0, 2, 0, 0, 1)},
    "squeezenet_v1_1": {"default": _launches(16, 1, 8, 0, 0, 0, 0, 0, 1),
                        "merge_1x1": _launches(12, 1, 8, 0, 0, 0, 0, 0, 1)},
}
VIT_LAUNCHES = _launches(0, 50, 0, 0, 0, 0, 12, 0, 0)
SSD_LAUNCHES = _launches(0, 0, 8, 5, 0, 0, 0, 0, 1)
# ragged int8 GEMMs (m, k, n, byte offset of x, residual): with the zoo's
# shapes they reach every tile of the GEMM plan (128x128, 128x64, 64x128,
# 64x64), split-K and not, x copied 16, 8, 4 bytes or padded, output widths
# 16, 8, 4, 2, 1 (kernels/shift_matmul.py: plan)
RAGGED_GEMMS = [(2048, 192, 1024, 0, False), (197, 768, 2304, 0, True),
                (16, 64, 8464, 0, True), (300, 200, 130, 0, True), (33, 196, 99, 0, False),
                (33, 50, 20, 0, True), (40, 64, 48, 4, False), (1, 3072, 768, 0, True)]
# ragged pot4 GEMMs (m, k, n, byte offset of x): K = 2, 16, 48 and 2 * odd,
# N = 1, 16, 24, 48 and 1000, x at every alignment, M = 1 and 63, a K * BN
# too large for one slab; with the zoo's shapes they reach every variant of
# the pot4 plan (BM 128 and 64, BN 16-128, x copied 16, 8, 4 bytes or
# padded, output widths 16-1, no split, a slab split and a wave split;
# kernels/shift_matmul.py: plan_pot4)
RAGGED_POT4 = [(1, 2, 1, 0), (63, 16, 16, 0), (63, 48, 24, 0), (100, 34, 48, 0),
               (130, 50, 1000, 0), (1, 2048, 1000, 0), (63, 96, 200, 8), (300, 200, 130, 4),
               (70, 64, 36, 2), (65, 66, 99, 1), (20000, 4608, 128, 0)]
# chains on given plans ((b, h, w, cin, cm, cout, down), (g, r, wc, c, bn)):
# bands and whole images, clusters of 1 to 16 CTAs, MMA widths 32 and 64,
# narrow bands, ragged channels (kernels/qblocks.py: make_plan)
GIVEN_CHAIN_PLANS = [((2, 9, 13, 48, 64, 64, True), (1, 2, 13, 1, 64)),
                     ((2, 9, 13, 64, 40, 64, False), (1, 3, 13, 1, 32)),
                     ((1, 12, 30, 32, 32, 32, False), (1, 1, 7, 1, 32)),
                     ((2, 14, 14, 64, 64, 128, True), (1, 4, 14, 2, 32)),
                     ((3, 7, 7, 256, 256, 256, False), (1, 7, 7, 4, 64)),
                     ((5, 7, 7, 512, 512, 512, False), (2, 7, 7, 8, 64)),
                     ((4, 8, 8, 64, 32, 64, False), (3, 8, 8, 1, 32)),
                     ((1, 7, 7, 512, 512, 512, False), (1, 7, 7, 16, 32)),
                     ((2, 6, 6, 40, 16, 40, False), (1, 6, 6, 1, 32))]
# ragged stems (b, h, w, cin, cout, k, padding): k 1, 3, 5 and 7, odd H
# and W, cin 1-4, cout 8-256 (one to eight 32-channel chunks, the last
# partial), VALID and SAME, f32 rows 16 does not divide (41 x 1 x 4 bytes:
# the 4-byte copies) and int8 rows 4 does not divide (read in the
# conversion) (kernels/qstem.py: plan)
RAGGED_STEMS = [(3, 37, 41, 1, 16, 5, "SAME"), (3, 33, 19, 2, 24, 5, "VALID"),
                (1, 30, 30, 4, 130, 7, "SAME"), (3, 45, 31, 3, 64, 7, "SAME"),
                (2, 9, 7, 3, 8, 1, "SAME"), (2, 15, 13, 3, 96, 3, "SAME"),
                (2, 17, 21, 2, 32, 3, "VALID"), (5, 23, 29, 1, 64, 3, "SAME"),
                (2, 21, 19, 4, 32, 7, "VALID"), (2, 11, 11, 4, 256, 5, "SAME")]
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
    ``options``. -> (engines[label][batch], cpu_engines[label], (graph,
    params))."""
    t = time.time()
    graph, params, mb = load_round_trip(name, **kwargs)
    engines, cpu_engines = make_engines(graph, params, options)
    log(f"artifact {name}: {len(params)} tensors, {mb:.1f} MB, "
        f"transform + save + load + engines {time.time() - t:.1f} s")
    return engines, cpu_engines, (graph, params)


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
    w2 = w2.contiguous()  # the Engine's int8 weights are K-major views
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


def _note_chain_plans(stats, x, blocks):
    from tf2_tpu_torch.kernels import qblocks

    b, h, w, cin = x.shape
    for blk in blocks:
        cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
        p = qblocks.launch_plan(b, h, w, cin, cm, cout, "wd" in blk, x.device)
        stats.chain_plans.add((p.whole, p.g, p.c, p.bn, "wd" in blk))
        cin = cout


def _chain_blocks(rng, dev, cin, cm, cout, nblocks, down, relu, extreme=False):
    """Random blocks (``_ragged_chains``'s scales), or with ``extreme`` +-127
    weights and es that clip both ends."""
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
            if extreme:
                blk["w" + key] = rng.choice(np.array([127, -127], np.int8), size=wshape)
                blk["es" + key] = (rng.uniform(0.5, 8.0, n) / (127 * np.sqrt(kk))).astype(np.float32)
            else:
                blk["w" + key] = rng.integers(-127, 128, wshape, dtype=np.int8)
                blk["es" + key] = (rng.uniform(0.5, 2.0, n) * 40
                                   / (127 * 127 * np.sqrt(kk))).astype(np.float32)
            blk["eb" + key] = rng.normal(0, 3, n).astype(np.float32)
        blocks.append({k_: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray) else v
                       for k_, v in blk.items()})
    return blocks


def _given_plan_chains(stats, rng, dev):
    """Two-block chains on each plan of GIVEN_CHAIN_PLANS (given to the
    wrapper, not picked): relu on and off on random inputs, and +-127
    inputs on +-127 weights, against the plain chain."""
    from tf2_tpu_torch.kernels import qblocks

    chosen = qblocks.launch_plan
    try:
        for (b, h, w, cin, cm, cout, down), given in GIVEN_CHAIN_PLANS:
            p = qblocks.make_plan(b, h, w, cm, *given)
            qblocks.launch_plan = lambda *a, p=p: p
            for relu, extreme in ((True, False), (False, False), (True, True)):
                blocks = _chain_blocks(rng, dev, cin, cm, cout, 2, down, relu, extreme)
                x = torch.as_tensor(rng.choice(np.array([127, -127], np.int8), size=(b, h, w, cin))
                                    if extreme else rng.integers(-127, 128, (b, h, w, cin),
                                                                 dtype=np.int8)).to(dev)
                stats.check("qblockchain", f"{b}x{h}x{w}x{cin} cm{cm} {p.name} relu={relu} "
                            f"extreme={extreme}", qblocks.qblockchain(x, blocks),
                            qblocks.qblockchain_plain(x, blocks))
            stats.chain_plans.update({(p.whole, p.g, p.c, p.bn, d) for d in (down, False)})
            log(f"given chain plan {b}x{h}x{w}x{cin} cm{cm} cout{cout}: {p.name}")
    finally:
        qblocks.launch_plan = chosen


def _ragged_chains(rng, dev):
    """Chains off the main path, each block on the plan the wrapper picks:
    bands that do not divide H, Cm not a multiple of 16, Cin != Cout with a
    downsample, 1-3 blocks with the adds' relu on and off, stage 4 at batch
    1, clusters of whole images. -> (blocks, x, name)."""
    cases = []
    for b, h, w, cin, cm, cout, nblocks, down in [
            (64, 9, 13, 48, 40, 64, 2, True), (64, 9, 13, 64, 40, 64, 1, False),
            (96, 12, 12, 32, 32, 96, 3, True), (3, 8, 8, 64, 16, 64, 3, False),
            (1, 7, 7, 2048, 512, 2048, 2, False), (5, 7, 7, 512, 512, 512, 2, False),
            (6, 14, 14, 256, 256, 256, 1, False)]:
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
        self.gemm_plans = set()   # (tile, split, avec, ovec, residual, prepared)
        self.pot4_plans = set()   # (bm, bn, avec, ovec, split_for, prepared)
        self.chain_plans = set()  # (whole, g, c, bn, down)
        self.qlrn_exact = [0, 0]  # qlrn elements on the exact steps, of those checked

    def note_plans(self, kernel, node, params, x_q):
        """Record the plan variant of an int8 GEMM or chain call."""
        from tf2_tpu_torch.kernels import dispatch, qblocks, shift_matmul

        if kernel == "qmatmul_int8":
            x = _main_input(x_q)
            x2 = x.reshape(-1, x.shape[-1])
            residual = (x_q[1], 1.0) if isinstance(x_q, tuple) else None
            w = params[node.params[0]]
            n = w.shape[-1]
            w2 = w.reshape(-1, n)
            p = shift_matmul.launch_plan(x2, n, residual)
            self.gemm_plans.add((p.tile, p.splits > 1, p.avec, p.ovec, residual is not None,
                                 shift_matmul.prepared_ld(w2) is not None))
        elif kernel == "qmatmul_pot4":
            x = _main_input(x_q)
            w = params[node.params[0]]
            p = shift_matmul.launch_plan_pot4(x.reshape(-1, x.shape[-1]), w.shape[-1])
            self.pot4_plans.add((p.bm, p.bn, p.avec, p.ovec, p.split_for,
                                 shift_matmul.prepared_ld(w) is not None))
        elif kernel == "qblockchain":
            b, h, w, cin = x_q.shape
            for blk in dispatch.chain_blocks(node, params):
                cm, cout = blk["w1"].shape[1], blk["w3"].shape[1]
                p = qblocks.launch_plan(b, h, w, cin, cm, cout, "wd" in blk, x_q.device)
                self.chain_plans.add((p.whole, p.g, p.c, p.bn, "wd" in blk))
                cin = cout

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
        self.note_plans(kernel, node, params, x_q)
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
            if (node.op not in ("qconv2d", "qdense") or node.attrs.get("wfmt") == "wpack2"
                    or node.name in eng.stem_nodes):
                continue  # the wpack2 stem and the stem on qstem: phase_stems
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


def _gemm_variants(stats, rng, dev):
    """qmatmul_int8 on RAGGED_GEMMS, each with its weight prepared (K-major,
    as the Engine holds it) and as given (prepared on the call, counted),
    against its plain version; the plans are printed and recorded."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.kernels import shift_matmul

    for m, k, n, off, resid in RAGGED_GEMMS:
        xs = torch.zeros(m * k + off, dtype=torch.int8, device=dev)
        xs[off:] = torch.as_tensor(rng.integers(-127, 128, m * k, dtype=np.int8)).to(dev)
        x = xs[off:].view(m, k)
        w = torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
        es = torch.as_tensor((rng.uniform(0.5, 3.0, n) / (127 * np.sqrt(k)))
                             .astype(np.float32)).to(dev)
        eb = torch.as_tensor(rng.normal(0, 5, n).astype(np.float32)).to(dev)
        residual = None
        if resid:
            residual = (torch.as_tensor(rng.integers(-127, 128, (m, n), dtype=np.int8)).to(dev),
                        0.61)
        p = shift_matmul.launch_plan(x, n, residual)
        for relu, wq in ((True, shift_matmul.prepare_weight(w)), (False, w)):
            prepared = shift_matmul.prepared_ld(wq) is not None
            kernels.reset_launch_counts()
            y = shift_matmul.qmatmul_int8(x, wq, es, eb, relu, residual)
            if kernels.prepared_per_call()["qmatmul_int8"] != (0 if prepared else 1):
                raise RuntimeError(f"qmatmul_int8 {m}x{k}x{n}: per-call preparation miscounted")
            stats.check("qmatmul_int8", f"ragged {m}x{k}x{n} {p.name} prepared={prepared}", y,
                        shift_matmul.qmatmul_int8_plain(x, w, es, eb, relu, residual))
            stats.gemm_plans.add((p.tile, p.splits > 1, p.avec, p.ovec, resid, prepared))
        log(f"ragged qmatmul_int8 {m}x{k}x{n} residual={resid}: {p.name}")


def _pot4_variants(stats, rng, dev):
    """qmatmul_pot4 on RAGGED_POT4, each with its codes prepared (K-major,
    as the Engine holds them) and as given (prepared on the call, counted),
    relu on and off, on random and on +-127 inputs with max-magnitude codes,
    against its plain version; the plans are printed and recorded."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.kernels import shift_matmul
    from tf2_tpu_torch.transform import potq

    for m, k, n, off in RAGGED_POT4:
        xs = torch.zeros(m * k + off, dtype=torch.int8, device=dev)
        x = xs[off:].view(m, k)
        es = torch.as_tensor((rng.uniform(0.5, 3.0, n) / (64 * np.sqrt(k)))
                             .astype(np.float32)).to(dev)
        eb = torch.as_tensor(rng.normal(0, 3, n).astype(np.float32)).to(dev)
        p = shift_matmul.launch_plan_pot4(x, n)
        for extreme in (False, True):
            if extreme:
                xv = rng.choice(np.array([-127, 127], np.int8), m * k)
                codes = rng.choice(np.array([7, 15], np.uint8), (k, n))
            else:
                xv = rng.integers(-127, 128, m * k, dtype=np.int8)
                codes = rng.integers(0, 16, (k, n)).astype(np.uint8)
            x.copy_(torch.as_tensor(xv).view(m, k).to(dev))
            packed = torch.as_tensor(potq.pack_codes(codes)).to(dev)
            for relu, w in ((True, shift_matmul.prepare_weight(packed)), (False, packed)):
                prepared = shift_matmul.prepared_ld(w) is not None
                kernels.reset_launch_counts()
                y = shift_matmul.qmatmul_pot4(x, w, es, eb, relu)
                if kernels.prepared_per_call()["qmatmul_pot4"] != (0 if prepared else 1):
                    raise RuntimeError(f"qmatmul_pot4 {m}x{k}x{n}: per-call preparation "
                                       "miscounted")
                stats.check("qmatmul_pot4", f"ragged {m}x{k}x{n}+{off} {p.name} "
                            f"prepared={prepared} extreme={extreme}", y,
                            shift_matmul.qmatmul_pot4_plain(x, packed, es, eb, relu))
                stats.pot4_plans.add((p.bm, p.bn, p.avec, p.ovec, p.split_for, prepared))
        log(f"ragged qmatmul_pot4 {m}x{k}x{n} x offset {off}: {p.name}")
    # x = -128 against codes of +-64: every accumulator -+128 * 64 * K, at
    # and past the 2^22 of the epilogue's conversion without an instruction
    for k in (512, 514, 516):
        x = torch.full((70, k), -128, dtype=torch.int8, device=dev)
        for code in (7, 15):
            packed = torch.as_tensor(potq.pack_codes(np.full((k, 40), code, np.uint8))).to(dev)
            acc = 128 * 64 * k * (-1 if code == 7 else 1)
            es = torch.full((40,), 2.0 ** -10, dtype=torch.float32, device=dev)
            eb = torch.as_tensor((-acc * 2.0 ** -10 + rng.uniform(-60, 60, 40))
                                 .astype(np.float32)).to(dev)
            y = shift_matmul.qmatmul_pot4(x, shift_matmul.prepare_weight(packed), es, eb, False)
            stats.check("qmatmul_pot4", f"accumulator bound K={k} code={code}", y,
                        shift_matmul.qmatmul_pot4_plain(x, packed, es, eb, False))


def phase_ragged_kernels(stats, dev):
    """The conv/GEMM kernels on shapes off the main paths."""
    rng = np.random.default_rng(4)
    _gemm_variants(stats, rng, dev)
    _pot4_variants(stats, rng, dev)
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
    _qlrn_boundaries(stats, rng, dev)
    stats.raise_on_mismatch("the qlrn kernel disagrees with its plain version")
    log(f"qlrn: {stats.k['qlrn']['checks']} checks, max |err| {stats.k['qlrn']['max_abs_err']}")


def _qlrn_boundaries(stats, rng, dev):
    """qlrn with y / s_out on and next to every .5 boundary: for each scale
    set of QLRN_SCALES, radius 1 and 2, C = 64 and 192 (the fast kernel)
    and 13 (the generic one), and each
    k = 0 .. 126, s_out = |v| / (k + 1/2) for an element's v = y before the
    division, and the f32 values either side of it. The certified epilogue
    sends those elements to the exact steps; their count is reported and
    must not be 0."""
    from tf2_tpu_torch.kernels import qlrn

    slow = torch.zeros(1, dtype=torch.int32, device=dev)
    elements = 0
    for (s_in, _, alpha), radius, c in itertools.product(QLRN_SCALES, (1, 2), (64, 192, 13)):
        x = torch.as_tensor(rng.integers(-127, 128, (129, c), dtype=np.int8)).to(dev)
        kw = dict(radius=radius, alpha=alpha, beta=0.75, bias=1.0)
        v = qlrn.lrn_f32(x.to(torch.float32) * np.float32(s_in), **kw).flatten()
        big = v[v.abs() > 1].cpu().numpy()
        picks = big[rng.integers(0, big.size, 127)]
        for k, vj in zip(range(127), picks):
            s0 = np.float32(abs(vj) / (k + 0.5))
            for s_out in (s0, np.nextafter(s0, np.float32(1)), np.nextafter(s0, np.float32(0))):
                kw_k = dict(kw, s_in=s_in, s_out=float(s_out))
                stats.check("qlrn", f"boundary k={k} c={c} {kw_k}",
                            qlrn.qlrn(x, slow_count=slow, **kw_k), qlrn.qlrn_plain(x, **kw_k))
                elements += x.numel()
    stats.qlrn_exact = [int(slow), elements]
    log(f"qlrn near .5 boundaries: {int(slow)} of {elements} elements took the exact steps")
    if not int(slow):
        raise RuntimeError("qlrn: the certified epilogue's exact steps were never taken")


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
        _note_chain_plans(stats, x, blocks)
    _given_plan_chains(stats, rng, images[1].device)
    log("chain plans taken (whole, G, C, BN, downsample): "
        + ", ".join(map(str, sorted(stats.chain_plans))))
    kinds = {(whole, c > 1, g > 1, bn, down) for whole, g, c, bn, down in stats.chain_plans}
    for need in ({k[0] for k in kinds} == {False, True}, {k[1] for k in kinds} == {False, True},
                 True in {k[2] for k in kinds}, {k[3] for k in kinds} == {32, 64},
                 {k[4] for k in kinds} == {False, True}):
        if not need:
            raise RuntimeError(f"chain plan variants not all reached: {sorted(kinds)}")
    stats.raise_on_mismatch("the chain kernel disagrees with the plain chain")
    log(f"chains: {stats.k['qblockchain']['checks']} checks, max |err| "
        f"{stats.k['qblockchain']['max_abs_err']}")
    return plain_envs


def routed_launches(eng, expected, graph):
    """``expected`` (a forward's launches with every node on ``kernel``)
    moved by the routes the Engine resolved at load: a GEMM node on
    ``kernel_int8`` launches the int8 GEMM in place of the pot4 one, a node
    on ``library`` no kernel; a k x k conv on ``kernel_int8`` stays on its
    conv kernel. ``graph``: the artifact's, which names each node's
    weight format before the decode."""
    from tf2_tpu_torch.kernels import dispatch

    if not eng.routes:
        return expected
    if graph is None:
        raise RuntimeError(f"{eng.graph.name}: routed nodes {sorted(eng.routes)} and no graph")
    out, src, final = dict(expected), graph.node_map(), eng.graph.node_map()
    for name, route in eng.routes.items():
        if dispatch.runs_gemm(final[name], "int8"):
            out["qmatmul_" + src[name].attrs["wfmt"]] -= 1
            if route == "kernel_int8":
                out["qmatmul_int8"] += 1
    return out


def phase_main(label, engines, cpu_engine, images, plain_envs, expected, same_as=None,
               out_shape=(1000,), graph=None):
    """A path through Engine.run: launch counts per forward must equal
    ``expected`` as the Engine's routes move it (``routed_launches``, on the
    artifact's ``graph``); returns (launches per b64 forward, summary,
    outputs by batch). The outputs must be finite, (B, *out_shape). At batch 1 every
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
        want = routed_launches(eng, expected, graph)
        if counts != want:
            raise RuntimeError(f"{label} b{b}: launches per forward {counts}, expected {want} "
                               f"(routes {eng.routes})")
        if any(kernels.prepared_per_call().values()):
            raise RuntimeError(f"{label} b{b}: weights prepared on a forward: "
                               f"{kernels.prepared_per_call()}")
        if b == 64:
            launches = counts
        all_logits[b] = logits
        if (tuple(logits.shape) != (len(images[b]), *out_shape)
                or not bool(torch.isfinite(logits).all())):
            raise RuntimeError(f"{label} b{b}: outputs {tuple(logits.shape)} "
                               f"not finite (B, {out_shape})")
        if same_as is not None and not torch.equal(logits, same_as[b]):
            raise RuntimeError(f"{label} b{b}: logits differ from the default Engine's")
        _, env = execute(eng.graph, intermediates=True, plain_nodes=eng.plain_nodes,
                         library_nodes=eng.library_nodes)(eng.params, image=images[b])
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
                            "nodes_checked": len(eng.graph.nodes), "routes": eng.routes,
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
    equal to the default's bit for bit; the default Engines captured
    (phase_captured) and the routes (phase_routing). Returns (launches per
    b64 forward of the default Engine, summary)."""
    engines, cpu_engines, art = phase_artifact(name, ZOO_OPTIONS)
    envs = phase_kernels(engines["default"], images, stats, timed=False)
    if any(n.op == "qlrn" for n in engines["default"][64].graph.nodes):
        phase_qlrn(engines["default"], envs, stats)
    routes = phase_stems(name, engines["default"], cpu_engines["default"], images, stats)
    launches, summary, logits = phase_main(name, engines["default"], cpu_engines["default"],
                                           images, envs, ZOO_LAUNCHES[name]["default"],
                                           graph=art[0])
    summary["stem_routes"] = routes
    merged_envs = phase_kernels(engines["merge_1x1"], images, stats, timed=False)
    _, summary["merge_1x1"], _ = phase_main(f"{name} merge_1x1", engines["merge_1x1"],
                                            cpu_engines["merge_1x1"], images, merged_envs,
                                            ZOO_LAUNCHES[name]["merge_1x1"], same_as=logits,
                                            graph=art[0])
    summary["captured"] = phase_captured(name, engines["default"], summary, seed=len(name))
    summary["routing"] = phase_routing(name, *art, engines["default"], images)
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
    if name == "vit_b16":
        summary["captured"] = phase_captured(name, engines, summary, seed=19)
    log(f"{name}: kernels " + ", ".join(f"{k} {v['checks']} checks" for k, v in stats.k.items()))
    return launches, summary


def check_gemm_variants(stats):
    """After phases 4-10: the int8 GEMM calls have reached every tile of
    its plan, split-K and not, each copy width of x (16, 8, 4, padded) and
    of the output (16, 8, 4, 2, 1), the residual on and off, and a
    prepared and a per-call weight."""
    variants = sorted(stats.gemm_plans)
    log("qmatmul_int8 plans taken (tile, split, x copy, out copy, residual, prepared): "
        + ", ".join(map(str, variants)))
    want = [set(range(4)), {False, True}, {0, 4, 8, 16}, {1, 2, 4, 8, 16}, {False, True},
            {False, True}]
    for i, need in enumerate(want):
        if {v[i] for v in variants} != need:
            raise RuntimeError(f"qmatmul_int8 plan variants not all reached: {variants}")


def check_pot4_variants(stats):
    """After phases 4-9: the pot4 GEMM calls have reached every tile height
    (128, 64) and width (16, 32, 64, 128) of its plan, each copy width of x
    (16, 8, 4, padded) and of the output (16, 8, 4, 2, 1), no split, a
    slab split and a wave split, and a prepared and a per-call weight."""
    variants = sorted(stats.pot4_plans)
    log("qmatmul_pot4 plans taken (bm, bn, x copy, out copy, split, prepared): "
        + ", ".join(map(str, variants)))
    want = [{64, 128}, {16, 32, 64, 128}, {0, 4, 8, 16}, {1, 2, 4, 8, 16},
            {"", "slab", "wave"}, {False, True}]
    for i, need in enumerate(want):
        if {v[i] for v in variants} != need:
            raise RuntimeError(f"qmatmul_pot4 plan variants not all reached: {variants}")


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
    """Phase 12 for one model's stem, at batch 64 and 1. The Engine's stem
    node (routed at load to the qstem kernel, ``Engine.stem_nodes``, its
    weight prepared) on the f32 image, its launches counted from 0 (one
    qstem launch, no weight prepared), equal to qstem_plain; the two-pass
    route (a stem qstem does not take), quantize + the stride-2 conv kernel
    called directly (the yardstick), equal to it; fused_qstem on the prepared and on the HWIO
    weight, on the f32 image and on the quantized int8 image with -128 in
    it, relu on and off, and +-127; the wpack2 node (the conv kernel's
    stride-(2, 1) entry) equal to the Engine's stem node and to its plain
    version, on random and +-127 packed inputs; the space_to_depth route
    equal to the Engine's stem node. Times the four routes (the whole stem
    node and its kernel alone) and bf16 F.conv2d; with ``timed``
    (ResNet-50), qstem and the stride-(2, 1) conv at batch 64 into the
    kernels line. -> route times by batch."""
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

    routes = {}
    for b, eng in engines.items():
        x = images[b]
        if stem.name not in eng.stem_nodes:
            raise RuntimeError(f"{name} b{b}: the Engine did not route its stem to qstem "
                               f"(stem_nodes {sorted(eng.stem_nodes)})")
        w_p, es, eb = (eng.params[p] for p in stem.params)
        w_q = w_p.contiguous()  # HWIO, as the artifact holds it
        kernels.reset_launch_counts()
        y = dispatch.qconv2d(stem, eng.params, x)  # the Engine's stem node
        counts = kernels.launch_counts()
        if counts != {**dict.fromkeys(counts, 0), "qstem": 1} or any(
                kernels.prepared_per_call().values()):
            raise RuntimeError(f"{name} b{b}: the stem node launched {counts}, prepared "
                               f"{kernels.prepared_per_call()}")
        kw_ = dict(padding=padding, relu=relu, scale=s_in)
        want = qstem.fused_qstem(x, w_q, es, eb, plain=True, **kw_)
        stats.check("qstem", f"{name} b{b} the Engine's stem node", y, want)
        pads = qconv.resolve_pads(padding, kh, kw, 2, 2, x.shape[1], x.shape[2])
        conv_kw = dict(kshape=(kh, kw, cin, cout), pads=pads, relu=relu, wfmt="int8")
        x_q = dispatch.quantize(x, s_in)
        stats.check("qconv_s2", f"{name} b{b} quantize + qconv_s2 against the stem node",
                    qconv.qconv_s2(x_q, w_q, es, eb, **conv_kw), y)
        x_q128 = x_q.clone()
        x_q128.view(-1)[::7] = -128  # the int8 path takes -128 as it is
        for r, (xin, scale), w in itertools.product((relu, not relu),
                                                    ((x, s_in), (x_q128, None)), (w_p, w_q)):
            kw_ = dict(padding=padding, relu=r, scale=scale)
            stats.check("qstem", f"{name} b{b} relu={r} scale={scale} "
                        f"prepared={w is w_p}", qstem.fused_qstem(xin, w, es, eb, **kw_),
                        qstem.fused_qstem(xin, w_q, es, eb, plain=True, **kw_))
        for extreme in (True, False):
            xa, wa, esa = _stem_adversarial(rng, x_q, w_q, extreme)
            kw_ = dict(padding=padding, relu=relu)
            stats.check("qstem", f"{name} b{b} +-127 extreme={extreme}",
                        qstem.fused_qstem(xa, qstem.prepare_weight(wa), esa, eb, **kw_),
                        qstem.fused_qstem(xa, wa, esa, eb, plain=True, **kw_))
        # the wpack2 stem and its stride-(2, 1) conv
        y2 = dispatch.qconv2d(packed, pparams, x)
        stats.check("qconv_s2x1", f"{name} b{b} wpack2 against the Engine's stem node", y2, y)
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
                        s2d_route(x), y)
        # the routes side by side: the whole stem node, and its kernel alone
        # (the qstem node is one launch of the kernel)
        n = 20 if b == 64 else 100
        r = {"qstem": (lambda: dispatch.qconv2d(stem, eng.params, x),) * 2,
             "conv_s2": (lambda: qconv.qconv_s2(dispatch.quantize(x, s_in), w_q, es, eb,
                                                **conv_kw),
                         lambda: qconv.qconv_s2(x_q, w_q, es, eb, **conv_kw)),
             "wpack2": (lambda: dispatch.qconv2d(packed, pparams, x),
                        lambda: qconv.qconv_s2x1(xp, wp, es, eb, relu=relu, **pk))}
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
            _time_stem_kernels(stats, x, w_q, es, eb, y, stem, eng.params, xp, wp, pk, y2)
    stats.raise_on_mismatch(f"{name}: the stem kernels disagree with their plain versions")
    return routes


def _time_stem_kernels(stats, x, w_q, es, eb, y, stem, params, xp, wp, pk, y2):
    """qstem (the Engine's stem node, one launch) and the stride-(2, 1) conv
    at the ResNet-50 b64 stem into the kernels line (one launch a forward
    each), beside their plain versions, bf16 F.conv2d and their bounds:
    qstem reads the f32 image, the weight, es and eb once and writes the
    int8 output once, 2 operations a multiply-accumulate inside the image;
    the packed conv reads the packed int8 image (its W pads included)
    instead."""
    from tf2_tpu_torch.kernels import dispatch, qconv, qstem

    kh, kw, cin, cout = stem.attrs["kshape"]
    s_in, relu, padding = stem.attrs["s_in"], stem.attrs["relu"], stem.attrs["padding"]
    b, h, w, _ = x.shape
    (ph0, _), (pw0, _) = qconv.resolve_pads(padding, kh, kw, 2, 2, h, w)
    _, taps_y = _taps(h, kh, 2, ph0, y.shape[1])
    _, taps_x = _taps(w, kw, 2, pw0, y.shape[2])
    wmat = qstem.fold_weight(w_q)
    plan = qstem.plan(b, h, w, cin, cout, kh, qstem._norm_padding(padding))
    stats.add("qstem", {"node": stem.name, "x": list(x.shape), "kshape": [kh, kw, cin, cout],
                        "plan": plan.name},
              cuda_ms(lambda: dispatch.qconv2d(stem, params, x), 20),
              cuda_ms(lambda: qstem.qstem_plain(x, wmat, es, eb, kh=kh, kw=kw, padding=padding,
                                                relu=relu, scale=s_in), 3),
              cuda_ms(_bf16_conv(x, w_q, 2, kh // 2 if padding == "SAME" else 0), 20),
              (x.numel() * 4 + w_q.numel() + 8 * cout + y.numel()) / H100_BYTES_PER_S * 1e3,
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
    """The stem kernel off the zoo's shapes (RAGGED_STEMS) on f32 input and
    on int8 input with -128 in it, relu on and off, its weight prepared
    (as the Engine holds it) and as given (prepared on the call, counted);
    on f32 inputs on and next to every half-integer multiple of the scale;
    the stride-(2, 1) conv on ragged packed inputs."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.kernels import qconv, qstem

    rng = np.random.default_rng(9)
    for b, h, w, cin, cout, k, padding in RAGGED_STEMS:
        w_q = torch.as_tensor(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).to(dev)
        es = torch.as_tensor((rng.uniform(0.5, 4.0, cout) / (127 * np.sqrt(k * k * cin)))
                             .astype(np.float32)).to(dev)
        eb = torch.as_tensor(rng.normal(0, 20, cout).astype(np.float32)).to(dev)
        xf = torch.as_tensor(rng.standard_normal((b, h, w, cin), dtype=np.float32)).to(dev)
        xq = torch.as_tensor(rng.integers(-128, 128, (b, h, w, cin), dtype=np.int8)).to(dev)
        for relu, (xin, scale), wt in itertools.product(
                (False, True), ((xf, 0.013), (xq, None)), (qstem.prepare_weight(w_q), w_q)):
            kw_ = dict(padding=padding, relu=relu, scale=scale)
            kernels.reset_launch_counts()
            got = qstem.fused_qstem(xin, wt, es, eb, **kw_)
            prepared = qstem.prepared_ld(wt) is not None
            if kernels.prepared_per_call()["qstem"] != (0 if prepared else 1):
                raise RuntimeError(f"qstem {b}x{h}x{w}x{cin}: per-call preparation miscounted")
            stats.check("qstem", f"ragged {b}x{h}x{w}x{cin} k{k} {padding} -> {cout} {kw_} "
                        f"prepared={prepared}", got,
                        qstem.fused_qstem(xin, w_q, es, eb, plain=True, **kw_))
        p = qstem.plan(b, h, w, cin, cout, k, padding)
        log(f"ragged stem {b}x{h}x{w}x{cin} k{k} {padding} -> {cout}: {p.name}")
    # the certified quantize: every f32 input on a half-integer multiple of
    # the scale, and its f32 neighbours, where the division decides
    w_q = torch.as_tensor(rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8)).to(dev)
    es = torch.full((64,), 2e-4, dtype=torch.float32, device=dev)
    eb = torch.zeros(64, dtype=torch.float32, device=dev)
    for scale in (0.013, 0.02, 0.5, 1.7):
        odd = rng.integers(-140, 140, (2, 29, 29, 3)) + 0.5
        half = (odd * np.float32(scale)).astype(np.float32)
        for xv in (half, np.nextafter(half, np.float32(np.inf)),
                   np.nextafter(half, np.float32(-np.inf))):
            x = torch.as_tensor(xv).to(dev)
            kw_ = dict(padding="SAME", relu=False, scale=scale)
            stats.check("qstem", f"quantize near .5, scale {scale}",
                        qstem.fused_qstem(x, qstem.prepare_weight(w_q), es, eb, **kw_),
                        qstem.fused_qstem(x, w_q, es, eb, plain=True, **kw_))
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
            summary["stem_routes"] = phase_stems("ssd", engines["default"],
                                                 cpu_engines["default"], images, stats)
        _, summary[case], dets = phase_main(f"ssd {case}", engines["default"],
                                            cpu_engines["default"], images, envs, SSD_LAUNCHES,
                                            out_shape=(100, 6))
        summary[case]["kept_per_image_b64"] = float((dets[64][..., 4] > 0).sum()) / 64
        if case == CASES[0]:  # phase 16: a forward that waits on the host is not captured
            try:
                engines["default"][1].build()
            except RuntimeError as e:
                if "waits on the host" not in str(e) or engines["default"][1].built:
                    raise
                summary["build_refused"] = str(e)
                log(f"ssd: build refused: {e}")
            else:
                raise RuntimeError("ssd: build captured a forward that waits on the host")
        log(f"ssd {case}: {summary[case]['kept_per_image_b64']:.2f} detections an image kept")
    return summary


def phase_captured(label, engines, eager, seed: int):
    """Phase 16 for one path, after its eager phases: on each Engine (by
    batch), three seeded inputs through the eager forward (its launches,
    which phase_main checked, counted); then ``Engine.build``: its warm-up
    forward and its capture must launch twice those (the wrappers count at
    capture, not at replay); then three
    replays on those inputs must equal the eager outputs bit for bit and
    launch nothing through a wrapper, and prepare no weight. The captured
    forward timed by ``Engine.benchmark`` beside the eager one (``eager``:
    phase_main's summary). Leaves the Engines built. Returns the summary."""
    from tf2_tpu_torch import kernels

    rng = np.random.default_rng(seed)
    summary = {}
    for b, eng in engines.items():
        shape = tuple(eng.graph.inputs["image"].shape)
        xs = [torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).cuda()
              for _ in range(3)]
        kernels.reset_launch_counts()
        want = [eng.run(image=xs[0])]
        expected = kernels.launch_counts()
        want += [eng.run(image=x) for x in xs[1:]]
        kernels.reset_launch_counts()
        t = time.time()
        eng.build(image=xs[0])
        torch.cuda.synchronize()
        build_s = time.time() - t
        counts = kernels.launch_counts()
        if counts != {k: 2 * v for k, v in expected.items()}:
            raise RuntimeError(f"{label} b{b}: build launched {counts}, expected twice "
                               f"{expected} (warm-up and capture)")
        kernels.reset_launch_counts()
        got = [eng.run(image=x) for x in xs]
        if any(kernels.launch_counts().values()) or any(kernels.prepared_per_call().values()):
            raise RuntimeError(f"{label} b{b}: a replay went through a wrapper: "
                               f"{kernels.launch_counts()}")
        if not eng.built or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"{label} b{b}: the captured forward differs from the eager one")
        r = eng.benchmark(iters=20 if b == 64 else 100, reps=3, image=xs[0])
        summary[f"b{b}"] = {"captured_ms": r["latency_s"] * 1e3,
                            "captured_img_per_s": r["throughput_per_s"],
                            "captured_per_rep_ms": [t * 1e3 for t in r["per_rep_s"]],
                            "eager_ms": eager[f"b{b}"]["latency_ms"], "build_s": build_s}
        log(f"{label} b{b}: captured, 3 replays equal the eager forward; "
            f"{r['latency_s'] * 1e3:.4f} ms/forward captured against "
            f"{eager[f'b{b}']['latency_ms']:.4f} eager (build {build_s:.2f} s)")
    return summary


def phase_donation(graph, params, engines):
    """Phase 16, ResNet-50: Engine(donate_inputs=True), built, at batch 64
    and 1: outputs equal the built Engine's without donation on three
    seeded inputs, each donated tensor's storage freed after its call.
    Returns the built donated Engine at batch 64 (phase 20 drives it)."""
    from tf2_tpu_torch.runtime import Engine

    rng = np.random.default_rng(16)
    kept = None
    for b, ref in engines.items():
        shape = tuple(ref.graph.inputs["image"].shape)
        xs = [torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).cuda()
              for _ in range(3)]
        want = [ref.run(image=x) for x in xs]
        eng = Engine(graph.with_batch_size(b), params, donate_inputs=True).build(
            image=xs[0].clone())
        for x, w in zip(xs, want):
            mine = x.clone()
            if not torch.equal(eng.run(image=mine), w) or mine.untyped_storage().nbytes():
                raise RuntimeError(f"donated Engine b{b}: outputs differ or the input was kept")
        if b == 64:
            kept = eng
        del eng
    log("resnet50: the donated Engines equal the others at b64 and b1, inputs freed")
    return kept


def _forced_engine(graph, params, route):
    """An Engine with every conv and dense node that has ``route`` on it:
    ``kernel`` (``set_use_kernels(True)``), ``library``
    (``set_use_kernels(False)``) or ``kernel_int8`` (a table sending every
    such key there)."""
    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.kernels import autotune, dispatch

    if route != "kernel_int8":
        dispatch.set_use_kernels(route == "kernel")
        try:
            return zoo_engine(graph, params)
        finally:
            dispatch.set_use_kernels(None)
    shapes = activation_shapes(graph, params)
    routes = {}
    for n in graph.nodes:
        a = n.attrs
        if n.op == "qconv2d" and "kernel_int8" in dispatch.conv_choices(
                a["kshape"], a.get("strides", [1, 1]), a.get("padding", "SAME"),
                a.get("groups", 1), a["wfmt"]):
            routes[autotune.conv_key(shapes[n.inputs[0]], a["kshape"], a.get("strides", [1, 1]),
                                     a.get("groups", 1), a["wfmt"])] = route
        elif n.op == "qdense" and a.get("wfmt") == "pot4" and len(n.inputs) == 1:
            routes[autotune.dense_key(shapes[n.inputs[0]], a["kshape"], a["wfmt"])] = route
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/routing.json"
        with open(path, "w") as f:
            json.dump({"routes": routes, "detail": {}}, f)
        autotune.set_table_path(path)
        try:
            return zoo_engine(graph, params)
        finally:
            autotune.set_table_path(None)


def phase_routing(name, graph, params, engines, images):
    """Phase 17 for one zoo CNN at batch 64 and 1: the committed routing
    table (kernels/routing_defaults/, read where no tuned table exists) is
    the one the Engines loaded; the default Engine (routed by it) equals
    ``set_use_kernels(True)``'s bit for bit, its routed nodes equal to
    their plain versions; and Engines with every node that has the route
    on ``kernel_int8`` and on ``library`` each equal the plain path node
    by node and ``set_use_kernels(True)``'s logits. Returns the summary."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.kernels import autotune

    table = autotune._load()
    source = autotune.table_path() if autotune._read_json(autotune.table_path())["routes"] \
        else autotune.default_path()
    if source == autotune.default_path() and table != autotune._read_json(source):
        raise RuntimeError(f"routing: the loaded table is not the committed {source}")
    summary = {"table": source, "table_routes": sum(v != "kernel" for v in table["routes"].values())}
    for b, default in engines.items():
        g = graph.with_batch_size(b)
        want = _forced_engine(g, params, "kernel").run(image=images[b])
        if not torch.equal(default.run(image=images[b]), want):
            raise RuntimeError(f"{name} b{b}: the routed Engine differs from set_use_kernels(True)")
        checked = {"default": len(default.routes)}
        for route in ("kernel_int8", "library"):
            eng = _forced_engine(g, params, route)
            if not eng.routes or set(eng.routes.values()) != {route}:
                raise RuntimeError(f"{name} b{b} {route}: routes {eng.routes}")
            out, env = execute(eng.graph, intermediates=True, library_nodes=eng.library_nodes)(
                eng.params, image=images[b])
            _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params,
                                                                         image=images[b])
            differ = [n.name for n in eng.graph.nodes if not torch.equal(env[n.name],
                                                                         plain[n.name])]
            if differ or not torch.equal(out, want) or not torch.equal(eng.run(image=images[b]),
                                                                       want):
                raise RuntimeError(f"{name} b{b} {route}: nodes differ: {differ[:5]}")
            checked[route] = len(eng.routes)
            del eng
        if default.routes:  # the committed table's routed nodes
            _, env = execute(default.graph, intermediates=True,
                             library_nodes=default.library_nodes)(default.params,
                                                                  image=images[b])
            _, plain = execute(default.graph, intermediates=True, plain=True)(
                default.params, image=images[b])
            if any(not torch.equal(env[k], plain[k]) for k in default.routes):
                raise RuntimeError(f"{name} b{b}: a routed node differs from plain")
        summary[f"b{b}"] = {"routed_nodes": checked}
        log(f"{name} b{b}: routed Engine equals set_use_kernels(True); routed nodes "
            f"{checked}, each equal to the plain path")
    return summary


def phase_wide_stems(stats, dev):
    """Phase 12, the stems the stem kernel's plan has no launch for (k 9,
    cout 288; coverage_cases.WIDE_STEMS): fused_qstem at 224x224 (b2, f32
    and int8 images, relu on and off) on the quantize and the stride-2 conv
    kernel (counted in qstem.TWO_PASS), equal to qstem_plain; and an Engine
    (coverage_cases.stem_artifact) whose stem stays outside its stem plan,
    its stem node equal to qstem_plain, eager and built."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.bench import coverage_cases
    from tf2_tpu_torch.kernels import qstem
    from tf2_tpu_torch.runtime import Engine

    rng = np.random.default_rng(12)
    before = qstem.TWO_PASS["qstem"]
    calls = 0
    for k, cout in coverage_cases.WIDE_STEMS:
        w_q = torch.as_tensor(rng.integers(-127, 128, (k, k, 3, cout), dtype=np.int8)).to(dev)
        es = torch.as_tensor((rng.uniform(0.5, 4.0, cout) / (127 * np.sqrt(k * k * 3)))
                             .astype(np.float32)).to(dev)
        eb = torch.as_tensor(rng.normal(0, 20, cout).astype(np.float32)).to(dev)
        xf = torch.as_tensor(rng.standard_normal((2, 224, 224, 3), dtype=np.float32)).to(dev)
        xq = torch.as_tensor(rng.integers(-128, 128, (2, 224, 224, 3), dtype=np.int8)).to(dev)
        for relu, (xin, scale) in itertools.product((False, True), ((xf, 0.013), (xq, None))):
            kw_ = dict(padding="SAME", relu=relu, scale=scale)
            kernels.reset_launch_counts()
            got = qstem.fused_qstem(xin, w_q, es, eb, **kw_)
            if kernels.launch_counts()["qconv_s2"] != 1 or kernels.launch_counts()["qstem"]:
                raise RuntimeError(f"wide stem k{k} cout {cout}: not on the two passes")
            calls += 1
            stats.check("qconv_s2", f"fused_qstem two passes k{k} -> {cout} {kw_}", got,
                        qstem.fused_qstem(xin, w_q, es, eb, plain=True, **kw_))
        art = coverage_cases.stem_artifact(k, cout, batch=2, image=64)
        eng = Engine(art.graph, art.params)
        stem = eng.graph.nodes[0]
        if eng.stem_nodes or "s_in" not in stem.attrs:
            raise RuntimeError(f"wide stem k{k} cout {cout}: stem plan {eng.stem_nodes}")
        x = torch.as_tensor(rng.standard_normal((2, 64, 64, 3), dtype=np.float32)).to(dev)
        from tf2_tpu_torch.graph import execute

        _, env = execute(eng.graph, intermediates=True)(eng.params, image=x)
        w, es_, eb_ = (eng.params[p] for p in stem.params)
        want = qstem.qstem_plain(x, qstem.fold_weight(w), es_, eb_, kh=k, kw=k, padding="SAME",
                                 relu=stem.attrs["relu"], scale=stem.attrs["s_in"])
        stats.check("qconv_s2", f"wide stem Engine k{k} -> {cout}", env[stem.name], want)
        logits = eng.run(image=x)
        if not torch.equal(eng.build(image=x).run(image=x), logits):
            raise RuntimeError(f"wide stem k{k} cout {cout}: captured differs from eager")
    stats.raise_on_mismatch("the wide stems disagree with qstem_plain")
    if qstem.TWO_PASS["qstem"] - before != calls:
        raise RuntimeError("qstem.TWO_PASS miscounted")
    log(f"wide stems {coverage_cases.WIDE_STEMS}: qstem.TWO_PASS {qstem.TWO_PASS['qstem']}, "
        "each equal to qstem_plain, through fused_qstem and an Engine (eager and built)")
    return {"two_pass_calls": qstem.TWO_PASS["qstem"]}


def phase_headline(engines, art, x, smi: str) -> dict:
    """Phase 18: the headline bench's line (tf2_tpu_torch/bench/headline.py)
    from the built default ResNet-50 Engines of phase 16 at batch 64 and 1,
    and each option the bench times (headline.OPTIONS) built here at 64;
    three spaced Engine.benchmark calls each."""
    from tf2_tpu_torch.bench import headline

    graph, params = art
    options = {k: zoo_engine(graph, params, **flags).build(image=x)
               for k, flags in headline.OPTIONS.items()}
    b64, b1, options = headline.measure(engines[64], engines[1], options, x, calls=3)
    line = headline.result_line(b64, b1, smi, options)
    log(f"headline: {json.dumps(line)}")
    return line


# phase 19: the kernels bias correction's replay must launch (ResNet-50)
REPLAY_KERNELS = ("qconv_s1", "qconv_s2", "qmatmul_pot4", "qmatmul_int8")
# the other zoo models through the CLI: (model, extra CLI arguments); SSD at
# its own image size, 256 (the CLI's default 224 is no multiple of its
# coarsest stride, 64)
TRANSFORM_ZOO = [("googlenet", []), ("squeezenet_v1_1", []), ("vit_b16", ["--wbits", "8"]),
                 ("ssd", ["--image", "256"])]
# f32 forward of fp32_ops_graph, card against CPU (TF32 off): each node's
# largest difference relative to its largest value
FP32_OPS_RTOL = 1e-5
SCALE_ATTRS = ("in_scale", "out_scale", "in_scales", "s_in", "s_out", "radd_scale", "scale",
               "sa", "sb", "so")


def run_cli(argv) -> dict:
    """``tf2_tpu_torch.transform.cli.main(argv)`` with its JSON line on the
    log; -> its report (the line's fields and ``stage_seconds``)."""
    import contextlib

    from tf2_tpu_torch.transform import cli

    report = {}
    with contextlib.redirect_stdout(sys.stderr):
        if cli.main([str(a) for a in argv], report=report):
            raise RuntimeError(f"cli {argv}: non-zero exit")
    log(f"cli {' '.join(map(str, argv))}: stages (s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in report["stage_seconds"].items()))
    return report


def _folded_fp32(name: str, batch: int, image: int, classes: int, seed: int = 0):
    """The folded f32 graph and params the CLI calibrates (init_params(seed),
    BN folded, patchified), on the card."""
    from tf2_tpu_torch.graph.init_params import init_params
    from tf2_tpu_torch.graph.optimize import patchify_stem
    from tf2_tpu_torch.models import get_model
    from tf2_tpu_torch.transform import fold_batch_norm

    g = get_model(name, batch=batch, image=image, classes=classes)
    fg, fp = patchify_stem(*fold_batch_norm(g, init_params(g, seed=seed)))
    return fg, {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in fp.items()}


def compare_artifacts(a, b) -> dict:
    """Two artifacts of one model (graph, params): the same graph but for
    the scale attributes, equal weight hashes (codes, int8 weights), and
    the largest relative difference of the scales and of es, and the
    largest difference of eb (output quanta)."""
    from tf2_tpu_torch.transform.export import _hash

    (ga, pa), (gb, pb) = a, b
    na, nb = json.loads(ga.to_json())["nodes"], json.loads(gb.to_json())["nodes"]
    if [(n["name"], n["op"], n["inputs"], n["params"]) for n in na] != \
            [(n["name"], n["op"], n["inputs"], n["params"]) for n in nb]:
        raise RuntimeError("artifacts: the graphs differ")
    worst = {"scale_rel": 0.0, "es_rel": 0.0, "eb_quanta": 0.0}
    for x, y in zip(na, nb):
        for k, v in x["attrs"].items():
            if k in SCALE_ATTRS:
                u, w = np.asarray(v, np.float64), np.asarray(y["attrs"][k], np.float64)
                worst["scale_rel"] = max(worst["scale_rel"], float((np.abs(u - w) / w).max()))
            elif v != y["attrs"][k]:
                raise RuntimeError(f"artifacts: {x['name']}.{k} {v} against {y['attrs'][k]}")
    for k, v in pa.items():
        if k.endswith((".wp", ".wq")):
            if _hash(v) != _hash(pb[k]):
                raise RuntimeError(f"artifacts: weight {k} differs")
        elif k.endswith(".es"):
            d = np.abs(v.astype(np.float64) - pb[k]) / np.abs(pb[k].astype(np.float64))
            worst["es_rel"] = max(worst["es_rel"], float(d.max()))
        elif k.endswith(".eb"):
            worst["eb_quanta"] = max(worst["eb_quanta"],
                                     float(np.abs(v.astype(np.float64) - pb[k]).max()))
    return worst


def _transform_engines(label, graph, params, images, stats, expected=None):
    """The default and the block_fusion=False Engines of a CLI artifact at
    batch 64 and 1 (plain_nodes empty), every conv and GEMM node against its
    plain version (phase 4), both through phase_main (the default's logits
    equal to the unfused Engine's), the default captured (phase 16).
    Returns (summary, the default Engines)."""
    engines, cpu_engines = make_engines(graph, params, {"unfused": {"block_fusion": False},
                                                        "default": {}})
    summary = {}
    envs = phase_kernels(engines["unfused"], images, stats, timed=False)
    _, summary["block_fusion=False"], logits = phase_main(
        f"{label} block_fusion=False", engines["unfused"], cpu_engines["unfused"], images, envs,
        EXPECTED_LAUNCHES if expected is None else expected["unfused"], graph=graph)
    envs = phase_kernels(engines["default"], images, stats, timed=False)
    _, summary["default"], _ = phase_main(
        label, engines["default"], cpu_engines["default"], images, envs,
        FUSED_LAUNCHES if expected is None else expected["default"], same_as=logits,
        graph=graph)
    summary["captured"] = phase_captured(label, engines["default"], summary["default"],
                                         seed=19)
    return summary, engines["default"]


def phase_transform(stats) -> dict:
    """Phase 19: the Transform Kit on the card (tf2_tpu_torch/transform/):
    the CLI from FP32 weights (init_params(seed 0)) to an artifact, which
    the Engines then run on the kernels. Returns the summary."""
    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.bench.coverage_cases import fp32_ops_graph
    from tf2_tpu_torch.graph import GraphBuilder, execute
    from tf2_tpu_torch.graph.execute import no_tf32
    from tf2_tpu_torch.graph.init_params import init_params
    from tf2_tpu_torch.kernels import dispatch
    from tf2_tpu_torch.transform import load_artifact

    t0 = time.time()
    summary = {}
    rng = np.random.default_rng(19)
    images = {b: torch.as_tensor(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)).cuda()
              for b in (64, 1)}
    with tempfile.TemporaryDirectory() as d:
        # 1. ResNet-50 W4 at full width on the card; the replay's launches
        out = f"{d}/resnet50"
        kernels.reset_launch_counts()
        report = run_cli(["--model", "resnet50", "--wbits", 4, "--batch", 4,
                          "--calib-batches", 2, "--estimator", "percentile", "--out", out])
        replay = {k: v for k, v in kernels.launch_counts().items() if v}
        log(f"transform resnet50: bias_correct launched {replay}")
        if any(not replay.get(k) for k in REPLAY_KERNELS):
            raise RuntimeError(f"transform: bias_correct's replay launched {replay}, "
                               f"expected each of {REPLAY_KERNELS}")
        summary["resnet50"] = {"cli": report, "bias_correct_launches": replay}
        # 2. its artifact (hashes verified) on the Engines
        graph, params = load_artifact(out, verify_hashes=True)
        s, default = _transform_engines("transform resnet50", graph, params, images, stats)
        summary["resnet50"].update(s)
        fg, fp = _folded_fp32("resnet50", 64, 224, 1000)
        with torch.no_grad(), no_tf32():
            y_fp = execute(fg.with_batch_size(64))(fp, image=images[64]).double()
        y_q = default[64].run(image=images[64]).double()
        rel = float(torch.linalg.norm(y_q - y_fp) / torch.linalg.norm(y_fp))
        cos = float((y_q.flatten() @ y_fp.flatten())
                    / (torch.linalg.norm(y_q) * torch.linalg.norm(y_fp)))
        summary["resnet50"]["logits_vs_fp32"] = {"rel_err": rel, "cosine": cos}
        log(f"transform resnet50 b64: logits against the folded FP32 forward: relative error "
            f"{rel:.4f}, cosine {cos:.4f}; captured "
            f"{summary['resnet50']['captured']['b64']['captured_ms']:.4f} ms/forward")
        del default, fg, fp
        # 3. card against CPU: the same CLI at image 64, batch 2
        arts = {}
        for platform in ("cpu", "cuda"):
            summary[f"resnet50_64_{platform}"] = run_cli(
                ["--model", "resnet50", "--wbits", 4, "--batch", 2, "--image", 64,
                 "--out", f"{d}/r64_{platform}", "--platform", platform])
            arts[platform] = load_artifact(f"{d}/r64_{platform}")
        diff = compare_artifacts(arts["cuda"], arts["cpu"])
        log(f"transform resnet50 at 64: card against CPU: weights equal, scales within "
            f"{diff['scale_rel']:.3g}, es within {diff['es_rel']:.3g} relative, eb within "
            f"{diff['eb_quanta']:.3g} quanta")
        if diff["scale_rel"] > 1e-5 or diff["eb_quanta"] > 1e-3 or diff["es_rel"] > 3e-5:
            raise RuntimeError(f"transform: card and CPU artifacts differ: {diff}")
        summary["card_vs_cpu"] = diff
        # 4. pruned
        out = f"{d}/pruned"
        summary["pruned"] = {"cli": run_cli(["--model", "resnet50", "--wbits", 4, "--prune", 0.3,
                                              "--out", out])}
        graph, params = load_artifact(out)
        widths = sorted({int(v.shape[-1]) for k, v in params.items() if k.endswith((".wp",
                                                                                   ".wq"))})
        log(f"transform pruned: output widths {widths}")
        engines, _ = make_engines(graph, params, {"unfused": {"block_fusion": False},
                                                  "default": {}})
        for label, engs in engines.items():
            phase_kernels(engs, images, stats, timed=False)
            kernels.reset_launch_counts()
            y = engs[64].run(image=images[64])
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"transform pruned {label}: logits not finite")
            summary["pruned"][label] = {"launches_b64": counts}
            log(f"transform pruned {label}: every conv and GEMM node equals its plain "
                f"version; launches {counts}")
        summary["pruned"]["widths"] = widths
        del engines
        # 5. the other zoo models at their defaults
        for name, extra in TRANSFORM_ZOO:
            out = f"{d}/{name}"
            rep = run_cli(["--model", name, "--calib-batches", 1, "--out", out, *extra])
            graph, params = load_artifact(out)
            x = torch.as_tensor(rng.standard_normal(tuple(graph.inputs["image"].shape),
                                                    dtype=np.float32)).cuda()
            eng = zoo_engine(graph, params)
            kernels.reset_launch_counts()
            y = eng.run(image=x)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            dispatch.set_use_kernels(False)
            try:
                y_off = zoo_engine(graph, params).run(image=x)
            finally:
                dispatch.set_use_kernels(None)
            if not counts or not torch.equal(y, y_off) or not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"transform {name}: outputs differ from "
                                   f"set_use_kernels(False)'s, or no kernel ran ({counts})")
            summary[name] = {"cli": rep, "launches": counts}
            log(f"transform {name}: Engine on its kernels {counts} equals "
                f"set_use_kernels(False)'s outputs {tuple(y.shape)}")
    # 6. the f32 ops no zoo Engine runs, card against CPU
    g = fp32_ops_graph(GraphBuilder, batch=2, image=112, dim=768, heads=12)
    params = init_params(g, seed=1)
    x = rng.standard_normal(tuple(g.inputs["image"].shape), dtype=np.float32)
    envs = {}
    for dev in ("cpu", "cuda"):
        with torch.no_grad(), no_tf32():
            _, env = execute(g, intermediates=True)(
                {k: torch.as_tensor(v).to(dev) for k, v in params.items()},
                image=torch.as_tensor(x).to(dev))
        envs[dev] = env
    worst = {n.name: float((envs["cuda"][n.name].cpu() - envs["cpu"][n.name]).abs().max()
                           / envs["cpu"][n.name].abs().max()) for n in g.nodes}
    log(f"transform fp32 ops: card against CPU, relative to each node's largest value: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    if max(worst.values()) > FP32_OPS_RTOL:
        raise RuntimeError(f"transform fp32 ops: card and CPU differ: {worst}")
    summary["fp32_ops"] = worst
    summary["seconds"] = time.time() - t0
    log(f"transform: phase 19 took {summary['seconds']:.1f} s")
    return summary


# phase 20: serving
SERVE_IMAGES = 256       # through the b64 server's threads, in 4 loader batches
SERVE_HTTP = 16          # more through POST /predict
SERVE_CLIENTS = 32
SERVE_B1 = 64            # sequential requests to the b1 server
SSD_SERVE_BATCH = 8
SSD_SERVE_IMAGE = 256
SERVE_WAIT_S = 120
# native preprocessing against its numpy reference: the reference test's
# bars (tests/test_preproc.py) at its cases: f32 within 1e-4 (3x37x53 -> 32);
# int8 within one quantum, over 99% exact (2x64x64 -> 48, scale 0.02); at
# the serving size (256x256 -> 224) int8 at the same bar and f32 within
# preproc.f32_error_bound (the library's float32 sample coordinates: 4.1e-4
# at 256x256, where 1e-4 does not hold for the reference's own library
# either, ROADMAP Queue 3)
PREPROC_F32_ATOL = 1e-4
PREPROC_I8_EXACT = 0.99
PREPROC_I8_SCALE = 0.02


def _sha256(path) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _rows_equal(label, got, want) -> None:
    """Each served response equal bit for bit to its row of a direct
    forward."""
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not np.array_equal(g, w)]
    if len(got) != len(want) or bad:
        raise RuntimeError(f"serving {label}: {len(bad)} of {len(want)} responses differ from "
                           f"the direct forward (first {bad[:5]})")


def _http(url, body=None, timeout=SERVE_WAIT_S):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def phase_serving(engines, donated, art, captured, smi: str) -> dict:
    """Phase 20, after phase 18 on phase 16's built default ResNet-50
    Engines (``engines`` by batch, ``donated`` its donated b64 Engine;
    ``captured`` phase 16's summary): native
    preprocessing, the prefetch loader, the continuous batcher and the HTTP
    server on the card, every served response equal bit for bit to its row
    of a direct forward; SSD served uncaptured; the serving and engine
    benches, the b64 time split, the measured peaks and the roofline.
    Returns the summary."""
    import io
    import threading
    import urllib.error
    from pathlib import Path

    from tf2_tpu_torch import kernels
    from tf2_tpu_torch.bench import peaks, roofline, serving_bench
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.serve import InferenceServer, serve_http
    from tf2_tpu_torch.serve.loader import PrefetchLoader
    from tf2_tpu_torch.utils import preproc

    t0 = time.time()
    summary = {"card": smi}
    shipped = Path(__file__).resolve().with_name("native") / "libtf2preproc.so"
    shipped_sha = _sha256(shipped)
    rng = np.random.default_rng(20)
    graph, params = art
    eng64, eng1 = engines[64], engines[1]
    image = eng64.graph.inputs["image"].shape[1]
    # (a) the native library, built from the source, against numpy
    t = time.time()
    lib = preproc.build()
    build_s = time.time() - t

    def against_numpy(batch, size):
        f32 = preproc.preprocess(batch, size)
        ref = preproc.preprocess(batch, size, force_numpy=True)
        err = float(np.abs(f32 - ref).max())
        # the numpy path's int8 is its f32 quantized (preproc.preprocess)
        ref_i8 = np.clip(np.round(ref / PREPROC_I8_SCALE), -127, 127).astype(np.int8)
        diff = np.abs(preproc.preprocess(batch, size, quant_scale=PREPROC_I8_SCALE).astype(int)
                      - ref_i8.astype(int))
        return f32, {"f32_max_abs_err": err, "i8_max_diff": int(diff.max()),
                     "i8_exact_share": float((diff == 0).mean())}

    _, ref_f32 = against_numpy(rng.integers(0, 256, (3, 37, 53, 3), dtype=np.uint8), 32)
    _, ref_i8 = against_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8), 48)
    raw = rng.integers(0, 256, (SERVE_IMAGES + SERVE_HTTP, 256, 256, 3), dtype=np.uint8)
    f32, served = against_numpy(raw[:64], image)
    bound = preproc.f32_error_bound(256, 256)
    summary["preproc"] = {"library": lib.name, "build_s": build_s, "f32_bound": bound,
                          "reference_cases": {"37x53->32": ref_f32, "64x64->48": ref_i8},
                          f"256x256->{image}": served}
    log(f"serving ({smi}): {lib.name} built in {build_s:.1f} s; the reference test's cases: "
        f"f32 within {ref_f32['f32_max_abs_err']:.3g}, int8 max diff {ref_i8['i8_max_diff']} "
        f"exact {ref_i8['i8_exact_share']:.6f}; 64 256x256 images to {image}: f32 within "
        f"{served['f32_max_abs_err']:.3g} (bound {bound:.3g}), int8 max diff "
        f"{served['i8_max_diff']}, exact {served['i8_exact_share']:.6f}")
    if (ref_f32["f32_max_abs_err"] > PREPROC_F32_ATOL or served["f32_max_abs_err"] > bound
            or max(ref_i8["i8_max_diff"], served["i8_max_diff"]) > 1
            or min(ref_i8["i8_exact_share"], served["i8_exact_share"]) <= PREPROC_I8_EXACT):
        raise RuntimeError(f"serving: native preprocessing off its numpy reference: "
                           f"{summary['preproc']}")
    # (b) the prefetch loader feeding the built b64 Engine
    eager = execute(eng64.graph, plain_nodes=eng64.plain_nodes, library_nodes=eng64.library_nodes)
    loader = PrefetchLoader([raw[i:i + 64] for i in range(0, SERVE_IMAGES, 64)], depth=2,
                            out_size=image).start()
    batches, direct = [], []
    while (batch := loader.get(timeout=SERVE_WAIT_S)) is not None:
        x = torch.from_numpy(batch).cuda()
        y = eng64.run(image=x)
        if not torch.equal(y, eager(eng64.params, image=x)):
            raise RuntimeError("serving: a loader batch's built forward differs from the eager one")
        batches.append(batch)
        direct.append(y.cpu().numpy())
    if len(batches) != SERVE_IMAGES // 64 or not np.array_equal(batches[0], f32):
        raise RuntimeError("serving: the loader's batches are not the preprocessed images")
    images, direct = np.concatenate(batches), np.concatenate(direct)
    log(f"serving ({smi}): PrefetchLoader (depth 2) fed {len(batches)} batches of 64 to the "
        "built b64 Engine, each forward equal to the eager one")
    # (c) the b64 server: 32 client threads and HTTP
    http_images = preproc.preprocess(raw[SERVE_IMAGES:], image)
    http_direct = eng64.run(image=torch.from_numpy(np.concatenate(
        [http_images, images[:64 - SERVE_HTTP]])).cuda())[:SERVE_HTTP].cpu().numpy()
    kernels.reset_launch_counts()
    srv = InferenceServer(eng64, 64).start()
    start_counts = kernels.launch_counts()
    want = {k: 2 * v for k, v in routed_launches(eng64, FUSED_LAUNCHES, graph).items()}
    if start_counts != want or not eng64.built:
        raise RuntimeError(f"serving b64: start() launched {start_counts}, expected {want} "
                           "(the build's warm-up and capture)")
    httpd = serve_http(srv, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    got, errors = {}, []

    def client(k):
        try:
            for i in range(k, SERVE_IMAGES, SERVE_CLIENTS):
                got[i] = srv.predict(images[i], timeout=SERVE_WAIT_S)
        except Exception as e:  # raised below: the phase fails
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        t = time.time()
        for th in threads:
            th.start()
        over_http = []
        for x in http_images:
            buf = io.BytesIO()
            np.save(buf, x)
            over_http.append(np.asarray(_http(f"{url}/predict", buf.getvalue())["output"],
                                        np.float32))
        for th in threads:
            th.join(timeout=SERVE_WAIT_S)
        served_s = time.time() - t
        if errors or any(th.is_alive() for th in threads):
            raise RuntimeError(f"serving b64: a client failed or hung: {errors[:1]}")
        health = _http(f"{url}/healthz")
        stats = _http(f"{url}/stats")
        try:
            _http(f"{url}/predict", b"garbage")
            bad_status = 200
        except urllib.error.HTTPError as e:
            bad_status = e.code
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    _rows_equal("b64 threads", [got[i] for i in range(SERVE_IMAGES)], direct)
    _rows_equal("b64 HTTP", over_http, http_direct)
    if kernels.launch_counts() != start_counts:
        raise RuntimeError("serving b64: a served replay went through a wrapper")
    if (not health.get("ok") or stats["requests"] != SERVE_IMAGES + SERVE_HTTP
            or stats["captured"] is not True or bad_status != 400):
        raise RuntimeError(f"serving b64: healthz {health}, stats {stats}, malformed body "
                           f"answered {bad_status}")
    summary["b64"] = {"requests": stats["requests"], "batches": stats["batches"],
                      "avg_occupancy": stats["avg_occupancy"], "seconds": served_s,
                      "start_launches": start_counts}
    log(f"serving b64 ({smi}): {SERVE_IMAGES} requests from {SERVE_CLIENTS} threads and "
        f"{SERVE_HTTP} over HTTP in {stats['batches']} batches (occupancy "
        f"{stats['avg_occupancy']:.3f}), each equal to its row of a direct forward; "
        f"start() launched {start_counts}; /healthz, /stats, 400 on a malformed body")
    # (d) the b1 server, sequential requests
    b1_direct = [eng1.run(image=torch.from_numpy(images[i:i + 1]).cuda())[0].cpu().numpy()
                 for i in range(SERVE_B1)]
    srv = InferenceServer(eng1, 1).start()
    try:
        b1_got = [srv.predict(images[i], timeout=SERVE_WAIT_S) for i in range(SERVE_B1)]
    finally:
        srv.stop()
    _rows_equal("b1", b1_got, b1_direct)
    summary["b1"] = {"requests": SERVE_B1, "equal_to_b64_rows": bool(all(
        np.array_equal(b1_direct[i], direct[i]) for i in range(SERVE_B1)))}
    log(f"serving b1 ({smi}): {SERVE_B1} sequential requests, each equal to the b1 Engine's "
        f"direct forward (equal to the b64 rows too: {summary['b1']['equal_to_b64_rows']})")
    # (e) SSD: its NMS waits on the host, so it is served uncaptured
    ssd = synthetic_quantized("ssd", seed=0, batch=SSD_SERVE_BATCH, image=SSD_SERVE_IMAGE,
                              classes=21)
    ssd_eng = zoo_engine(ssd.graph, ssd.params)
    xs = rng.standard_normal((2 * SSD_SERVE_BATCH, SSD_SERVE_IMAGE, SSD_SERVE_IMAGE, 3),
                             dtype=np.float32)
    ssd_direct = np.concatenate([ssd_eng.run(image=torch.from_numpy(xs[i:i + SSD_SERVE_BATCH])
                                             .cuda()).cpu().numpy()
                                 for i in range(0, len(xs), SSD_SERVE_BATCH)])
    kernels.reset_launch_counts()
    srv = InferenceServer(ssd_eng, SSD_SERVE_BATCH).start()
    ssd_got = {}

    def ssd_client(k):
        for i in range(k, len(xs), 4):
            ssd_got[i] = srv.predict(xs[i], timeout=SERVE_WAIT_S)

    try:
        threads = [threading.Thread(target=ssd_client, args=(k,)) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SERVE_WAIT_S)
        ssd_stats = srv.stats()
    finally:
        srv.stop()
    if len(ssd_got) != len(xs) or ssd_stats["captured"] or not ssd_stats["host_syncs"]:
        raise RuntimeError(f"serving ssd: {len(ssd_got)} of {len(xs)} served, stats {ssd_stats}")
    _rows_equal("ssd", [ssd_got[i] for i in range(len(xs))], ssd_direct)
    per_forward = routed_launches(ssd_eng, SSD_LAUNCHES, ssd.graph)
    ssd_counts = kernels.launch_counts()
    if ssd_counts != {k: ssd_stats["batches"] * v for k, v in per_forward.items()}:
        raise RuntimeError(f"serving ssd: launches {ssd_counts} over {ssd_stats['batches']} "
                           f"batches, expected {per_forward} a forward")
    summary["ssd"] = {"requests": len(xs), "batches": ssd_stats["batches"],
                      "captured": False, "host_syncs": ssd_stats["host_syncs"],
                      "launches": ssd_counts}
    log(f"serving ssd ({smi}): b{SSD_SERVE_BATCH} served uncaptured ({ssd_stats['host_syncs']}), "
        f"{len(xs)} (100, 6) detection rows equal to the direct forward; launches {ssd_counts}")
    del ssd_eng, srv
    # (f) the serving and engine benches, the time split
    bench = {"serving_b64": serving_bench.serving_load(graph, params, 64, 4.0, clients=24,
                                                       engine=eng64),
             "serving_b1": serving_bench.serving_load(graph, params, 1, 2.0, clients=4,
                                                      engine=eng1)}
    for donate, eng in ((True, donated), (False, eng64)):
        bench[f"engine_steady_{'donate' if donate else 'nodonate'}"] = \
            serving_bench.engine_steady(graph, params, 64, 2.0, donate, engine=eng)
    bench["split_b64"] = serving_bench.time_split(eng64, images[:64])
    summary["bench"] = bench
    for b in ("b64", "b1"):
        r = bench[f"serving_{b}"]
        log(f"serving_load {b} ({smi}): {r['img_per_s']:.1f} img/s, p50 {r['p50_ms']:.3f} "
            f"p95 {r['p95_ms']:.3f} p99 {r['p99_ms']:.3f} ms, occupancy "
            f"{r['avg_occupancy']:.3f}, {r['clients']} clients, captured {r['captured']}")
    log(f"engine_steady b64 ({smi}): donate {bench['engine_steady_donate']['img_per_s']:.1f}, "
        f"no donate {bench['engine_steady_nodonate']['img_per_s']:.1f} img/s")
    split = bench["split_b64"]
    log(f"time split b64 ({smi}): " + ", ".join(
        f"{k} {split[f'{k}_ms']:.3f}" for k in ("assemble", "copy_in", "replay", "copy_out",
                                                 "plumbing")) + f" ms (total "
        f"{split['total_ms']:.3f}; input {split['input_mb']:.1f} MB)")
    # (g) the measured peaks and the roofline of ResNet-50 b64
    measured = peaks.measure()
    roof = {}
    for label, pk in (("datasheet", roofline.DATASHEET),
                      ("measured", roofline.measured_peaks(measured, "chip_smoke"))):
        r = roofline.analyze(graph.with_batch_size(64), peaks=pk)
        roof[label] = {k: v for k, v in r.items() if k != "layers"}
        roof[label]["sol_fraction"] = r["sol_ms"] / captured["b64"]["captured_ms"]
    summary["peaks"], summary["roofline"] = measured, roof
    log(f"peaks ({smi}): int8 {measured['int8_tops']:.1f} TOP/s (data sheet 1979; _int_mm with "
        f"B row-major {measured['int8_tops_row_major_b']:.1f}, column-major "
        f"{measured['int8_tops_col_major_b']:.1f}), bf16 "
        f"{measured['bf16_tflops']:.1f} TFLOP/s (989), HBM 1r1w "
        f"{measured['hbm_1r1w_gbps']:.1f}, 2r1w {measured['hbm_2r1w_gbps']:.1f}, read "
        f"{measured['hbm_read_sum_gbps']:.1f} GB/s (3350)")
    log(f"roofline resnet50 b64 ({smi}): sol {roof['datasheet']['sol_ms']:.4f} ms (data sheet), "
        f"{roof['measured']['sol_ms']:.4f} ms (measured), sol_fraction "
        f"{roof['datasheet']['sol_fraction']:.4f} / {roof['measured']['sol_fraction']:.4f} of "
        f"the built {captured['b64']['captured_ms']:.4f} ms")
    if _sha256(shipped) != shipped_sha:
        raise RuntimeError("serving: native/libtf2preproc.so changed")
    summary["seconds"] = time.time() - t0
    log(f"serving: phase 20 took {summary['seconds']:.1f} s")
    return summary


def main() -> int:
    t0 = time.time()
    smi = phase_card()
    phase_build()
    engines, cpu_engines, art = phase_artifact("resnet50", RESNET_OPTIONS, depths=(3, 4, 6, 3))
    rng = np.random.default_rng(0)
    images = {b: torch.as_tensor(rng.standard_normal(
        (b, 224, 224, 3), dtype=np.float32)).cuda() for b in (64, 1)}
    stats = KernelStats()
    plain_envs = phase_kernels(engines["unfused"], images, stats, timed=True)
    phase_ragged_kernels(stats, images[1].device)
    unfused_launches, unfused, logits = phase_main(
        "resnet50 block_fusion=False", engines["unfused"], cpu_engines["unfused"], images,
        plain_envs, EXPECTED_LAUNCHES, graph=art[0])
    phase_kernels(engines["default"], images, stats, timed=False)
    fused_envs = phase_chains(engines["default"], images, stats)
    launches, summary, _ = phase_main("resnet50", engines["default"], cpu_engines["default"],
                                      images, fused_envs, FUSED_LAUNCHES, same_as=logits,
                                      graph=art[0])
    summary["block_fusion=False"] = unfused
    # each kernel's launches from the Engine its time comes from: the conv
    # and GEMM kernels' from the unfused one (phase 4 times them there, where
    # they run every conv), the chains' from the default
    launches_from = dict.fromkeys(launches, "resnet50 block_fusion=False b64")
    launches = dict(unfused_launches, qblockchain=launches["qblockchain"])
    launches_from["qblockchain"] = "resnet50 default b64"
    for option in ("phase_stem", "optimize"):
        envs = phase_kernels(engines[option], images, stats, timed=False)
        option_launches, summary[option], _ = phase_main(
            f"resnet50 {option}", engines[option], cpu_engines[option], images, envs,
            STEM_LAUNCHES[option], same_as=logits, graph=art[0])
        if option == "phase_stem":
            launches["qconv_s2x1"] = option_launches["qconv_s2x1"]
            launches_from["qconv_s2x1"] = "resnet50 phase_stem=True block_fusion=False b64"
    summary["stem_routes"] = phase_stems(
        "resnet50", engines["unfused"], cpu_engines["unfused"], images, stats, timed=True)
    phase_ragged_stems(stats, images[1].device)
    summary["wide_stems"] = phase_wide_stems(stats, images[1].device)
    summary["captured"] = {
        "default": phase_captured("resnet50", engines["default"], summary, seed=16),
        "block_fusion=False": phase_captured("resnet50 block_fusion=False", engines["unfused"],
                                             unfused, seed=17)}
    donated = phase_donation(*art, engines["default"])
    summary["routing"] = phase_routing("resnet50", *art, engines["default"], images)
    headline_line = phase_headline(engines["default"], art, images[64], smi)
    summary["serving"] = phase_serving(engines["default"], donated, art,
                                       summary["captured"]["default"], smi)
    del engines, cpu_engines, plain_envs, fused_envs, envs, art, donated
    zoo = {}
    for name in ZOO_LAUNCHES:
        zoo_launches, zoo[name] = phase_zoo(name, images, stats)
        if name == "googlenet":
            launches["qlrn"], launches_from["qlrn"] = zoo_launches["qlrn"], "googlenet b64"
    for name in ("vit_b16", "vit_b16_cls"):
        vit_launches, zoo[name] = phase_vit(name, images, stats)
        if name == "vit_b16":
            launches["qattention"], launches_from["qattention"] = (vit_launches["qattention"],
                                                                   "vit_b16 b64")
    check_gemm_variants(stats)
    check_pot4_variants(stats)
    zoo["qlrn_exact_path"] = {"elements": stats.qlrn_exact[1], "exact": stats.qlrn_exact[0]}
    zoo["ssd"] = phase_ssd(stats)
    zoo["vit_b16_cls_384"] = phase_vit384(stats)
    zoo["coverage"] = phase_coverage()
    zoo["transform"] = phase_transform(stats)
    if not all(launches.values()):
        raise RuntimeError(f"kernels launched no time on their paths: {launches}")
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        s = stats.k[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "launches_from": launches_from[name],
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_bound_ms"] * 2 >= s["bound_ms"] else "operations",
            "library_ms": s["library_ms"]})
    log(json.dumps({"checks": {k: v["checks"] for k, v in stats.k.items()},
                    "per_shape_b64": stats.rows}))
    wall_s = time.time() - t0
    log(f"wall time {wall_s:.1f} s")
    print(json.dumps(headline_line))
    print(json.dumps({"main_path": summary, **zoo, "card": smi, "wall_s": wall_s}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
