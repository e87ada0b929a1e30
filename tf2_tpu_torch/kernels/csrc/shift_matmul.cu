// Fused shift-quantized GEMM for Hopper: y = requant(x . decode(w)), int8 out.
//
// Replaces tf2_tpu/kernels/shift_matmul.py:
//   tf2_qmatmul_pot4  <- _qmm_pot4_kernel (:40, called by qmatmul_pot4 :89)
//   tf2_qmatmul_int8  <- _qmm_int8_kernel (:59, called by qmatmul_int8 :122)
// On the ResNet-50 path these run every 1x1 stride-1 conv (as a GEMM over
// B*H*W pixels, pot4 codes) and the fc (int8 weights). On the W8 ViT-B/16
// path tf2_qmatmul_int8 runs all 50 dense layers (M = B*T, K x N = 768 x
// 2304, 768 x 768, 768 x 3072, 3072 x 768), the 24 proj and mlp2 layers with
// the residual add folded into the epilogue (tf2_tpu/kernels/dispatch.py:
// 260-273 computes those outside any Pallas kernel).
//
// What bounds it on the card: the 1x1 convs of stages 1-2 at batch 64 move
// tens of MB of int8 activations for 64-256 MACs per byte (M = 200,704,
// K = 64..256): memory bytes bound them. Stages 3-4 (K = 512..2048,
// N = 512..2048) are bound by int8 tensor-core operations. The int8 GEMMs:
// ViT-B/16 at batch 64 (M = 12,544-12,608, K x N up to 768 x 3072) does
// 256-768 operations per byte moved and is bound by operations; the fc
// (M = 64 or 1, K = 2048, N = 1000) and every GEMM at batch 1 read each
// weight byte for one or a few rows and are bound by the weight bytes.
//
// What the design does about it. Both kernels read their weights K-major,
// prepared once at load (kernels/shift_matmul.py: prepare_weight), and both
// run int8 wgmma on 64-byte swizzled K-major tiles fed by a cp.async ring,
// laid out by a host plan cached per shape, with split-K where K overflows
// what a block holds or the grid is under one wave, and an epilogue that
// stages the int8 tile in shared memory so that rows leave in 16-byte
// chunks.
// tf2_qmatmul_pot4 (qmm_pot4.cuh, plan: shift_matmul.plan_pot4): the 4-bit
// codes stay packed in memory (half the weight bytes) and each block
// decodes one N-tile's codes once into a slab resident in shared memory,
// then, persistent, walks many M-tiles through it, A streaming through a
// 4-slot ring; the tile width follows N (16, 32, 64 or 128).
// tf2_qmatmul_int8 (qmm_int8.cuh, plan: shift_matmul.plan): one 128x128,
// 128x64, 64x128 or 64x64 output tile a block, A and W^T tiles through a
// 6-slot ring 4 steps ahead of the wgmma; split-K on grids under one wave,
// so that the fc and b1's GEMMs stream their weight bytes on every SM.
#include "qmm_int8.cuh"
#include "qmm_pot4.cuh"

namespace {

struct qmatmul_pot4;  // kernel tags, named after the wrappers
struct qmatmul_int8;

}  // namespace

// One pot4 GEMM launch but its X and output, laid out by the wrapper once
// for each weight, shape, X alignment and relu (kernels/shift_matmul.py:
// Pot4Launch, the same fields in the same order). wt (N, ldw) uint8: the
// packed codes' K-major rows (ldw % 16 == 0, 16-byte aligned, readable up
// to K/2 in every row); es/eb (N,) f32; ws and counters: the plan's split-K
// workspace, int32 zeros the kernel leaves zero (unused when splits is 1).
// X's rows are ldx apart (ldx >= K, zero past K), K even. bm, bn, avec (X's
// copy width: 16, else 4), ovec (the output's), splits, per (K steps a
// split) and grid: the plan (kernels/shift_matmul.py: plan_pot4).
struct Pot4Launch {
  const void* wt;
  const void* es;
  const void* eb;
  void* ws;
  void* counters;
  int m, n, k, ldx, ldw, relu, bm, bn, avec, ovec, splits, per, grid;
};

// x (M, ldx) int8; y (M, N) int8. Returns cudaGetLastError().
extern "C" int tf2_qmatmul_pot4(const void* x, void* y, const Pot4Launch* l, void* stream) {
  if (l->m <= 0 || l->n <= 0) return 0;
  if (l->k <= 0 || l->k % 2 || l->splits < 1 || l->per < 1 || l->grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tf2::pot4::Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const uint8_t*>(l->wt);
  p.es = static_cast<const float*>(l->es);
  p.eb = static_cast<const float*>(l->eb);
  p.y = static_cast<int8_t*>(y);
  p.ws = static_cast<int*>(l->ws);
  p.counters = static_cast<int*>(l->counters);
  p.M = l->m;
  p.N = l->n;
  p.K = l->k;
  p.ldx = l->ldx;
  p.ldw = l->ldw;
  p.relu = l->relu;
  p.ovec = l->ovec;
  // requant_byte's conversion through 1.5 * 2^23 is exact for |acc| <= 2^22;
  // |acc| <= 128 * 64 * K (x may be -128, a decoded code is at most 64)
  p.small = 128LL * 64 * l->k <= (1 << 22);
  p.splits = l->splits;
  p.per = l->per;
  p.mtiles = (l->m + l->bm - 1) / l->bm;
  p.items = (l->n + l->bn - 1) / l->bn * l->splits * p.mtiles;
  return tf2::pot4::launch_plan<qmatmul_pot4>(p, l->bm, l->bn, l->avec, l->grid, stream);
}

// x (M, K) int8 (16, 8 or 4-byte copies: avec); wt (N, ldw) int8, the
// weight's K-major rows (ldw % 16 == 0, 16-byte aligned, readable up to
// round_up(K, 16) in every row); es/eb (N,) f32; r (M, N) int8 or null: the
// residual, added in the epilogue as f32(r) * radd; y (M, N) int8. tile,
// avec, ovec (the output's and residual's copy width), splits: the plan
// (kernels/shift_matmul.py: plan); ws and counters its split-K workspace,
// int32 zeros the kernel leaves zero (unused when splits is 1). Returns
// cudaGetLastError().
extern "C" int tf2_qmatmul_int8(const void* x, const void* wt, int ldw, const void* es,
                                const void* eb, const void* r, void* y, int m, int n,
                                int k, int relu, float radd, int tile, int avec, int ovec,
                                void* ws, void* counters, int splits, void* stream) {
  tf2::mm::Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.ldw = ldw;
  p.es = static_cast<const float*>(es);
  p.eb = static_cast<const float*>(eb);
  p.r = static_cast<const int8_t*>(r);
  p.radd = radd;
  p.y = static_cast<int8_t*>(y);
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = m;
  p.N = n;
  p.K = k;
  p.relu = relu;
  p.avec = avec;
  p.ovec = ovec;
  p.splits = splits;
  if (m <= 0 || n <= 0) return 0;
  return tf2::mm::launch_plan<qmatmul_int8>(p, tile, stream);
}
