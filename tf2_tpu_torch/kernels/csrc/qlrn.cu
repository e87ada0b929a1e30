// Fused int8 LRN across channels for Hopper: int8 NHWC in, int8 out.
//
// Replaces tf2_tpu/kernels/qlrn.py:
//   tf2_qlrn  <- _qlrn_kernel (:66, called through _qlrn_call :83)
// On the GoogLeNet path it runs the two LRN layers (lrn_0 on 64 channels,
// lrn_1 on 192, both at 56x56).
//
// What it computes, per element (kernels/qlrn.py has the plain version):
//   xf  = f32(q) * s_in;  sq = xf * xf
//   win = the channel window [c - r, c + r] of sq, summed in double and
//         rounded once to f32 (exact in any order: the nonzero squares of
//         dequantized int8 values span at most 2^14 in magnitude)
//   t   = bias + alpha * win;  rs = 1 / sqrt(t);  y = (xf * rs) * sqrt(rs)
//   out = clip(rint(y / s_out), +-127)
// Each step is one correctly rounded operation (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn: no contracted FMA, no approximate rsqrt), so the
// result equals the plain PyTorch version bit for bit on the card and on
// the CPU.
//
// What bounds it on the card: memory bytes. It reads each int8 input once
// and writes each int8 output once, for about 20 flops an element.
//
// What the design does about it: the TPU kernel summed the window as an f32
// matmul against a (C, C) 0/1 band so that the window stays off the lanes;
// the card needs no such device. A block takes a run of whole pixels (P * C
// contiguous bytes, about 4 KB), copies it into shared memory 16 bytes a
// thread, squares every element once into an f32 array beside it, then
// computes every output of the run from shared memory and writes the run
// back 16 bytes a thread. Not done yet: keeping several runs in flight per
// block (cp.async) and cheaper correctly rounded square roots and
// divisions, which the 23 us bound at C = 192, batch 64 calls for.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRunBytes = 4096;  // target bytes of one block's run of pixels

struct qlrn;  // kernel tag, named after the wrapper

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Shared memory of a block, for runs of `run` bytes: the f32 squares, then
// the input run and the output run, each with up to 15 bytes of lead.
__host__ __device__ inline int in_base(int run) { return round16(4 * run); }
__host__ __device__ inline int out_base(int run) { return round16(in_base(run) + 16 + run); }
__host__ __device__ inline int smem_bytes(int run) { return out_base(run) + 16 + run; }

// Copy n bytes from src to dst, which lie at the same offset modulo 16:
// bytes up to the first 16-byte boundary, then 16-byte words, then the tail.
__device__ void copy_run(int8_t* dst, const int8_t* src, int n) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const int words = (n - head) >> 4;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < words; i += blockDim.x) d4[i] = s4[i];
  for (int i = head + (words << 4) + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <class Tag>
__global__ void __launch_bounds__(kThreads)
qlrn_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y, int m, int c,
            int radius, int pixels, float s_in, float s_out, float alpha, float bias) {
  extern __shared__ __align__(16) int8_t smem[];
  const int run = pixels * c;
  const int first = blockIdx.x * pixels;
  const int n = min(pixels, m - first) * c;
  const long long start = static_cast<long long>(first) * c;
  // each run sits in shared memory at its global offset modulo 16, so that
  // the 16-byte words line up on both sides
  float* s_sq = reinterpret_cast<float*>(smem);
  int8_t* s_x = smem + in_base(run) + (reinterpret_cast<uintptr_t>(x + start) & 15);
  int8_t* s_y = smem + out_base(run) + (reinterpret_cast<uintptr_t>(y + start) & 15);
  copy_run(s_x, x + start, n);
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float v = __fmul_rn(static_cast<float>(s_x[e]), s_in);
    s_sq[e] = __fmul_rn(v, v);
  }
  __syncthreads();
  // element e is channel ch of pixel p; both advance by kThreads elements
  const int dp = kThreads / c, dc = kThreads % c;
  int p = threadIdx.x / c, ch = threadIdx.x % c;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float* sq = s_sq + p * c;
    const int hi = min(ch + radius, c - 1);
    double acc = 0.0;
    for (int j = max(ch - radius, 0); j <= hi; ++j) acc += static_cast<double>(sq[j]);
    const float win = __double2float_rn(acc);
    const float xf = __fmul_rn(static_cast<float>(s_x[e]), s_in);
    const float t = __fadd_rn(__fmul_rn(win, alpha), bias);
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(t));
    const float v = __fmul_rn(__fmul_rn(xf, rs), __fsqrt_rn(rs));
    const float q = rintf(__fdiv_rn(v, s_out));
    s_y[e] = static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
    p += dp;
    ch += dc;
    if (ch >= c) {
      ch -= c;
      ++p;
    }
  }
  __syncthreads();
  copy_run(y + start, s_y, n);
}

}  // namespace

// The most channels a pixel may have: one pixel's squares, input and output
// within the 48 KB of shared memory a block gets without opting in.
extern "C" int tf2_qlrn_max_channels() { return (48 * 1024 - 64) / 6; }

// x, y (M, C) int8, contiguous; the window takes `radius` channels on each
// side. Scalars are f32. Returns cudaGetLastError().
extern "C" int tf2_qlrn(const void* x, void* y, int m, int c, int radius, float s_in,
                        float s_out, float alpha, float bias, void* stream) {
  if (m <= 0 || c <= 0 || radius < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pixels = c >= kRunBytes ? 1 : kRunBytes / c;
  if (c > tf2_qlrn_max_channels()) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(pixels * c);
  const unsigned blocks = static_cast<unsigned>((m + pixels - 1) / pixels);
  qlrn_kernel<qlrn><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(y), m, c, radius, pixels,
      s_in, s_out, alpha, bias);
  return static_cast<int>(cudaGetLastError());
}
