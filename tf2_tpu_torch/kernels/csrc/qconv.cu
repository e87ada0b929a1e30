// Fused shift-quantized k x k conv for Hopper, as an implicit GEMM over the
// unpadded NHWC image: y = requant(conv(x, decode(w))), int8 NHWC out.
//
// Replaces tf2_tpu/kernels/qconv.py:
//   tf2_qconv_s1  <- _qconv_s1_kernel (:98, called through _qconv_call :304)
//   tf2_qconv_s2  <- _qconv_s2_kernel (:166, same call)
// and runs the W-pair-packed stem (wfmt "wpack2", graph/optimize.
// pack_phase_stem), which the reference runs as one bf16 lax conv in XLA at
// strides (2, 1) (tf2_tpu/kernels/dispatch.py:154-173), not in Pallas:
//   tf2_qconv_s2x1 <- that conv
// The strides (SH, SW) are template parameters of both kernel families of
// qconv_pipe.cuh; the first template argument names the wrapper.
//
// What bounds it on the card (ResNet-50 b64): the 3x3 convs at 28x28 and
// below do 9 * C multiply-adds per input byte and are bound by int8
// tensor-core operations; the 3x3/s1 convs at 56x56 with 64 channels, the
// 1x1 stride-2 downsamples and the stems are bound by memory bytes (the
// 7x7 stem reads 9.6 MB and writes 51 MB).
//
// What the design does about it. The TPU kernels built padded and
// phase-folded copies of the image in VMEM so that every tap became an
// aligned slice; here there is no padded copy. The host plans each launch
// (kernels/qconv.py: plan): the variant, the tile, the copy widths and a
// table that gives each K chunk its tap (dy, dx) and channel, so the K
// loops divide by nothing; each output row's (image, iy0, ix0) is worked
// out once a block.
// - Pipelined kernel (every layer whose C and, for pot4, K/2 take 4-byte
//   copies): a 3-stage ring of dynamic shared memory filled with cp.async
//   (16, 8 or 4 bytes a copy, the largest that divides C; zero-filled with
//   src-size 0 on padding taps and past K), one barrier a 64-deep K step.
//   pot4 weights are copied packed (half the bytes) and decoded from
//   shared memory four codes at a time (byte-permute tables) into a B^T
//   tile one step ahead; int8 weights are transposed the same way. The
//   MMAs are int8 wgmma (m64nNk32) on 64B-swizzled K-major tiles, issued
//   asynchronously while the threads decode the next step. A comes from an
//   im2col tile gathered into the ring or, for stride-1 k x k convs, from
//   the input patch of a 2-D output tile copied into shared memory once
//   (ldmatrix into registers at each lane's pixel plus the step's tap).
//   Tiles 256x128 (two blocks' worth of rows share each decoded B^T),
//   128x128, 128x64 (N <= 64) and 64x64 (the smallest grids), chosen on
//   the host from (M, N, SMs).
// - Staged kernel (C = 3 and 6: the stems and wpack2): the input patch of
//   a 2-D output tile is copied into shared memory once, 16 bytes a
//   thread; the weights once a block; the im2col tile of each 32-deep K
//   step is built from shared memory (K = 147 runs as 160), on mma.sync.
// - Both requant in registers (qgemm.cuh's requant: two rounded f32 steps,
//   relu, rintf, clip), stage the int8 tile in shared memory and store it
//   16 bytes a thread.
// What still sets the time (PERF.md): each block's per-step decode and
// transpose of the pot4 weights, which every block repeats. Not done: TMA.
#include "qconv_pipe.cuh"

namespace {

struct qconv_s1;  // kernel tags, named after the wrappers
struct qconv_s2;
struct qconv_s2x1;

template <class Tag, int SH, int SW>
int conv(const void* x, const void* w, const void* es, const void* eb, void* y, int b,
         int h, int w_, int c, int oh, int ow, int kh, int kw, int pad_top, int pad_left,
         int n, int pot4, int relu, void* stream, const void* table, int variant, int avec,
         int bvec, int tile_h, int tile_w, void* ws, void* counters, int splits) {
  tf2::conv::Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.es = static_cast<const float*>(es);
  p.eb = static_cast<const float*>(eb);
  p.y = static_cast<int8_t*>(y);
  p.table = static_cast<const int*>(table);
  p.B = b;
  p.H = h;
  p.W = w_;
  p.C = c;
  p.OH = oh;
  p.OW = ow;
  p.KH = kh;
  p.KW = kw;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.N = n;
  p.K = kh * kw * c;
  p.M = b * oh * ow;
  p.relu = relu;
  p.avec = avec;
  p.bvec = bvec;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.splits = splits;
  if (p.M <= 0 || p.N <= 0) return 0;
  return pot4 ? tf2::conv::launch_variant<Tag, SH, SW, true>(p, variant, stream)
              : tf2::conv::launch_variant<Tag, SH, SW, false>(p, variant, stream);
}

}  // namespace

// x (B, H, W, C) int8; w (KH*KW*C/2, N) uint8 split-half PoT codes when pot4,
// else (KH*KW*C, N) int8 in HWIO order; es/eb (N,) f32; y (B, OH, OW, N)
// int8. pad_top/pad_left are the leading TF-SAME pads; the trailing pads
// follow from OH/OW. table, variant, avec, bvec, tile_h, tile_w, splits: the
// plan (kernels/qconv.py: plan), table on the device; ws and counters: its
// split-K workspace, int32 zeros the kernel leaves zero (unused when splits
// is 1). Returns cudaGetLastError().
#define TF2_QCONV_ENTRY(NAME, TAG, SH, SW)                                                   \
  extern "C" int NAME(const void* x, const void* w, const void* es, const void* eb, void* y, \
                      int b, int h, int w_, int c, int oh, int ow, int kh, int kw,          \
                      int pad_top, int pad_left, int n, int pot4, int relu, void* stream,   \
                      const void* table, int variant, int avec, int bvec, int tile_h,       \
                      int tile_w, void* ws, void* counters, int splits) {                   \
    return conv<TAG, SH, SW>(x, w, es, eb, y, b, h, w_, c, oh, ow, kh, kw, pad_top,         \
                             pad_left, n, pot4, relu, stream, table, variant, avec, bvec,  \
                             tile_h, tile_w, ws, counters, splits);                         \
  }

TF2_QCONV_ENTRY(tf2_qconv_s1, qconv_s1, 1, 1)
TF2_QCONV_ENTRY(tf2_qconv_s2, qconv_s2, 2, 2)
// stride 2 along H, 1 along W; the same operands
TF2_QCONV_ENTRY(tf2_qconv_s2x1, qconv_s2x1, 2, 1)
