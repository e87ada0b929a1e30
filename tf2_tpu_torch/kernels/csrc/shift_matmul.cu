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
// What the design does about it.
// tf2_qmatmul_pot4 (qgemm.cuh): a 128 x 128 output tile per block reads
// each activation byte once for 128 output channels and each decoded weight
// once for 128 pixels; 4-bit codes halve the weight bytes and are decoded
// in shared memory; the requant epilogue runs on the accumulators. Not done
// yet: a pipeline overlapping loads with MMA, wgmma (ROADMAP Queue 2 A).
// tf2_qmatmul_int8 (qmm_int8.cuh): the weight arrives K-major, prepared
// once at load, so both operands go by plain 16-byte cp.async into a
// 5-slot ring in wgmma's swizzled layout, 3 steps ahead of int8 wgmma, one
// step of wgmma in flight while the next copies are issued; the host plan
// (kernels/shift_matmul.py: plan) picks the tile (256x128 for ViT's large
// grids, down to 64x64 for small M), and splits K where the grid is under
// one wave so that the fc and b1's GEMMs stream their weight bytes on every
// SM; the epilogue stages the int8 tile (and the residual) in shared
// memory so that rows move in 16-byte chunks.
#include "qmm_int8.cuh"

namespace {

struct qmatmul_pot4;  // kernel tags, named after the wrappers
struct qmatmul_int8;

}  // namespace

// x (M, K) int8, wp (K/2, N) uint8 split-half PoT codes, es/eb (N,) f32,
// y (M, N) int8. K must be even. Returns cudaGetLastError().
extern "C" int tf2_qmatmul_pot4(const void* x, const void* wp, const void* es,
                                const void* eb, void* y, int m, int n, int k,
                                int relu, void* stream) {
  tf2::Args p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const uint8_t*>(wp);
  p.es = static_cast<const float*>(es);
  p.eb = static_cast<const float*>(eb);
  p.y = static_cast<int8_t*>(y);
  p.M = m;
  p.N = n;
  p.K = k;
  p.relu = relu;
  return tf2::launch<qmatmul_pot4>(p, stream);
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
