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
// N = 512..2048) are bound by int8 tensor-core operations.
//
// What the design does about it: a 128 x 128 output tile per block reads
// each activation byte once for 128 output channels and each decoded weight
// once for 128 pixels; 4-bit codes halve the weight bytes and are decoded in
// shared memory, one 16-byte load giving 32 codes; the requant epilogue runs
// on the accumulators in registers, so only int8 leaves the block. Not done
// yet: a cp.async/TMA pipeline overlapping loads with MMA, wgmma, and
// coalesced output stores (see qgemm.cuh).
#include "qgemm.cuh"

namespace {

struct qmatmul_pot4;  // kernel tags, named after the wrappers
struct qmatmul_int8;

tf2::Args gemm_args(const void* x, const void* w, const void* es, const void* eb,
                    void* y, int m, int n, int k, int relu) {
  tf2::Args p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.es = static_cast<const float*>(es);
  p.eb = static_cast<const float*>(eb);
  p.y = static_cast<int8_t*>(y);
  p.M = m;
  p.N = n;
  p.K = k;
  p.relu = relu;
  return p;
}

}  // namespace

// x (M, K) int8, wp (K/2, N) uint8 split-half PoT codes, es/eb (N,) f32,
// y (M, N) int8. K must be even. Returns cudaGetLastError().
extern "C" int tf2_qmatmul_pot4(const void* x, const void* wp, const void* es,
                                const void* eb, void* y, int m, int n, int k,
                                int relu, void* stream) {
  return tf2::launch<qmatmul_pot4, tf2::GEMM, 1, 1, true>(
      gemm_args(x, wp, es, eb, y, m, n, k, relu), stream);
}

// x (M, K) int8, w (K, N) int8, es/eb (N,) f32, y (M, N) int8; r (M, N)
// int8 or null: the residual, added in the epilogue as f32(r) * radd.
extern "C" int tf2_qmatmul_int8(const void* x, const void* w, const void* es,
                                const void* eb, const void* r, void* y, int m, int n,
                                int k, int relu, float radd, void* stream) {
  tf2::Args p = gemm_args(x, w, es, eb, y, m, n, k, relu);
  if (!r) return tf2::launch<qmatmul_int8, tf2::GEMM, 1, 1, false>(p, stream);
  p.r = static_cast<const int8_t*>(r);
  p.radd = radd;
  return tf2::launch<qmatmul_int8, tf2::GEMM, 1, 1, false, true>(p, stream);
}
