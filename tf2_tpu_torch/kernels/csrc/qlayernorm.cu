// Fused int8 layer norm for Hopper: int8 rows in, int8 rows out, one pass.
//
// Replaces no Pallas kernel: the reference computes its int8 layer norm in
// XLA ops (tf2_tpu/kernels/dispatch.py:433-451, qlayernorm), and the port's
// plain version (kernels/qlayernorm.py: qlayernorm_plain) in some 30 eager
// PyTorch kernels a node. On the ViT path it runs every layer norm (25 a
// ViT-B/16 forward, rows of 768 codes).
//
// What it computes, per row of D codes q (kernels/qlayernorm.py has the
// plain version):
//   S1  = sum q,  S2 = sum q^2                      exact integers
//   mu  = f32(f64(S1) / D)
//   var = f32(f64(D * S2 - S1^2) / f64(D * D))
//   inv = 1 / sqrt(var + eps)                       eps = f32(eps / s_in^2)
//   y   = ((f32(q) - mu) * inv) * g + b,  g = gamma / so, b = beta / so,
//                                         so = f32(s_out)
//   out = clip(rint(y), +-127)
// S1 and S2 are exact in int32 (|S2| <= D * 2^14 < 2^31 for D <= 4,096) and
// D * S2 - S1^2 in int64; each other step is one correctly rounded
// operation (__ddiv_rn, __fsqrt_rn, __fdiv_rn, __fsub_rn, __fmul_rn,
// __fadd_rn: no contracted FMA, no approximate reciprocal), so the result
// equals the plain version bit for bit on the card and on the CPU.
//
// What bounds it on the card: memory bytes. A row reads D bytes and writes
// D, and each code costs about a dozen instructions: ViT-B/16 at b64 moves
// 2 x 9.63 MB a node, 5.75 us at 3.35 TB/s.
//
// What the design does about it:
// - one warp a row: lane l reads the row's 8-byte words l, l + 32, ... all
//   at once and keeps them in registers for both passes, so the row is read
//   once and written once (at D = 768, three coalesced loads a lane);
// - S1 and S2 by dp4a on the packed codes, then a shuffle reduction across
//   the warp: no shared memory and no second read for the statistics;
// - g and b for the D columns computed once a block into shared memory,
//   while the block's first rows are in flight, and read as float4 without
//   bank conflicts;
// - persistent blocks of kWarps warps (as many as are resident on the
//   card), each warp walking rows kWarps * blocks apart; a warp asks for its
//   next row before it stores the current one.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// rows in flight a block: 16 warps measured 12.1 us a ViT-B/16 b64 node
// against 12.9 for 8 and 13.9 for 4 (persistent grids; 13.3-15.1 with one
// row a warp and no persistence; NVIDIA H100 80GB HBM3, 700 W)
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWords = 16;              // 8-byte words a lane holds
constexpr int kMaxWidth = 32 * 8 * kMaxWords;  // 4,096 codes a row

struct qlayernorm;  // kernel tag, named after the wrapper

struct Args {
  const int8_t* __restrict__ x;
  int8_t* __restrict__ y;
  const float* __restrict__ gamma;
  const float* __restrict__ beta;
  long long m;
  int d;
  float eps, so;
};

// The row's words of this lane (0 past the row's end, which add nothing to
// S1 and S2).
template <int W>
__device__ __forceinline__ void load_row(const Args& a, long long row, int lane, uint2 (&v)[W]) {
  const uint2* src = reinterpret_cast<const uint2*>(a.x + row * a.d);
  const int words = a.d >> 3;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int j = i * 32 + lane;
    v[i] = j < words ? src[j] : make_uint2(0u, 0u);
  }
}

// Four codes of one 32-bit word through the per-element steps; the output
// bytes packed in the same order.
__device__ __forceinline__ uint32_t norm4(uint32_t w, float4 g, float4 b, float mu, float inv) {
  const float gs[4] = {g.x, g.y, g.z, g.w};
  const float bs[4] = {b.x, b.y, b.z, b.w};
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xf = static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xf, mu), inv), gs[k]), bs[k]);
    const int q = static_cast<int>(fminf(fmaxf(rintf(y), -127.0f), 127.0f));
    out |= (static_cast<uint32_t>(q) & 0xffu) << (8 * k);
  }
  return out;
}

// Where column c's g and b lie in their shared table: the first halves of
// the row's words (columns 8j to 8j + 3) as float4 j, the second halves
// after them, so that lane j's float4 reads lie 16 bytes apart (no bank
// conflict).
__device__ __forceinline__ int table_index(int c, int words) {
  return 4 * (((c >> 2) & 1) * words + (c >> 3)) + (c & 3);
}

template <class Tag, int W>
__global__ void __launch_bounds__(kThreads) qlayernorm_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;        // gamma / so, D floats in table_index order
  float* sb = smem + a.d;  // beta / so, the same (D % 8 == 0: 16-byte aligned)
  const int lane = threadIdx.x & 31;
  const int words = a.d >> 3;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  uint2 v[W];
  if (row < a.m) load_row<W>(a, row, lane, v);
  for (int c = threadIdx.x; c < a.d; c += kThreads) {
    const int at = table_index(c, words);
    sg[at] = __fdiv_rn(a.gamma[c], a.so);
    sb[at] = __fdiv_rn(a.beta[c], a.so);
  }
  __syncthreads();
  const float4* g4 = reinterpret_cast<const float4*>(sg);
  const float4* b4 = reinterpret_cast<const float4*>(sb);
  const double dd = static_cast<double>(a.d);
  while (row < a.m) {  // uniform across the warp: every lane shuffles
    int s1 = 0, s2 = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int lo = static_cast<int>(v[i].x), hi = static_cast<int>(v[i].y);
      s1 = __dp4a(lo, 0x01010101, __dp4a(hi, 0x01010101, s1));
      s2 = __dp4a(lo, lo, __dp4a(hi, hi, s2));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const long long num = static_cast<long long>(a.d) * s2 - static_cast<long long>(s1) * s1;
    const float mu = __double2float_rn(__ddiv_rn(static_cast<double>(s1), dd));
    const float var = __double2float_rn(__ddiv_rn(__ll2double_rn(num), __dmul_rn(dd, dd)));
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, a.eps)));
    uint2 out[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int j = i * 32 + lane;
      if (j < words)
        out[i] = make_uint2(norm4(v[i].x, g4[j], b4[j], mu, inv),
                            norm4(v[i].y, g4[words + j], b4[words + j], mu, inv));
    }
    const long long next = row + step;
    if (next < a.m) load_row<W>(a, next, lane, v);
    uint2* dst = reinterpret_cast<uint2*>(a.y + row * a.d);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int j = i * 32 + lane;
      if (j < words) dst[j] = out[i];
    }
    row = next;
  }
}

// Launch the kernel for rows of w words a lane (1 <= w <= kMaxWords).
template <int W>
cudaError_t launch(int w, const Args& a, int sms, cudaStream_t stream) {
  if constexpr (W < kMaxWords) {
    if (w != W) return launch<W + 1>(w, a, sms, stream);
  }
  auto kernel = qlayernorm_kernel<qlayernorm, W>;
  const int smem = 2 * a.d * static_cast<int>(sizeof(float));
  // persistent blocks: as many as are resident at once (asked once for each
  // kernel and shared-memory size)
  static struct { int smem, per_sm; } seen[8];
  static int n_seen = 0;
  int per_sm = 0;
  for (int i = 0; i < n_seen && !per_sm; ++i)
    if (seen[i].smem == smem) per_sm = seen[i].per_sm;
  if (!per_sm) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    per_sm = per_sm > 0 ? per_sm : 1;
    if (n_seen < 8) seen[n_seen++] = {smem, per_sm};
  }
  const long long groups = (a.m + kWarps - 1) / kWarps;
  const long long fit = static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(groups < fit ? groups : fit), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The widest row the kernel takes: kMaxWords 8-byte words in each lane's
// registers. Its shared memory (8 bytes a column, 32 KB at the widest) stays
// within the 48 KB a block gets without opting in.
extern "C" int tf2_qlayernorm_max_width() { return kMaxWidth; }

// x, y (M, D) int8, contiguous, 8-byte aligned, D % 8 == 0; gamma, beta (D,)
// f32. eps: f32(eps / s_in^2); so: f32(s_out). Returns cudaGetLastError().
extern "C" int tf2_qlayernorm(const void* x, void* y, const void* gamma, const void* beta,
                              long long m, int d, float eps, float so, void* stream) {
  if (m <= 0 || d <= 0 || d % 8 || d > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 8 || reinterpret_cast<uintptr_t>(y) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.y = static_cast<int8_t*>(y);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.m = m;
  a.d = d;
  a.eps = eps;
  a.so = so;
  const int w = (d / 8 + 31) / 32;
  return static_cast<int>(launch<1>(w, a, sms, static_cast<cudaStream_t>(stream)));
}
