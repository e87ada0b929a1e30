// Shared core of the port's int8 kernels for Hopper (sm_90a): the requant
// epilogues, the mma.sync wrapper and the pot4 decode, included by
// shift_matmul.cu, qconv_pipe.cuh, qblocks.cu and qstem.cu; and the pot4
// GEMM main loop of qmatmul_pot4 (shift_matmul.cu). qmatmul_int8 runs its
// own main loop (qmm_int8.cuh).
//
// The kernel's first template argument is a tag type named after the Python
// wrapper that launches it (the keys of kernels.launch_counts()), so a
// profiler trace names each launch by its wrapper.
//
// One block computes a 128 x 128 tile of Y = epilogue(A . B), where A is
// (M, K) int8 row-major and B is 4-bit power-of-two codes packed two per
// byte in split-half layout (K/2, N), decoded to int8 inside the block, on
// the tensor cores with mma.sync.m16n8k32 (s8 x s8 -> s32).
//
// Split-half order: packed byte row r holds code k=r in its low nibble and
// code k=r+K/2 in its high nibble. A K-step covers packed rows
// [32s, 32s+32): its 64 reduction indices are {32s .. 32s+31} and
// {K/2+32s .. K/2+32s+31}, and the A tile loads exactly those columns. The
// integer sum does not depend on the order of k, so each packed byte is read
// and decoded once per block, for any even K, and no tile straddles K/2.
//
// Accumulator range: |acc| <= 127 * max|w| * K. On the ResNet-50 path the
// largest pot4 K is 4608 (127 * 64 * 4608 = 3.7e7) and the largest int8 K is
// the fc's 2048 (127 * 127 * 2048 = 3.3e7), both far below 2^31: int32 holds
// every sum exactly.
//
// Epilogue: acc * es and + eb are rounded as two separate f32 operations
// (__fmul_rn, __fadd_rn). A fused multiply-add would change the f32 value in
// about a quarter of the elements and break bit-exactness with the plain
// version. requant_resid (qmatmul_int8's residual, as the ViT's proj and
// mlp2) adds + f32(r) * radd as a third rounded step, r being the int8
// residual. Then relu, round half to even (rintf), clip to +-127.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf2 {
namespace {

constexpr int BM = 128;       // output rows (pixels) per block
constexpr int BN = 128;       // output channels per block
constexpr int BK = 64;        // reduction indices per K-step
constexpr int LDS = BK + 16;  // smem row stride in bytes: 80 keeps the
                              // fragment loads free of bank conflicts
constexpr int THREADS = 256;  // 8 warps as 2 (M) x 4 (N), each 64 x 32

struct Args {
  const int8_t* x;    // (M, K) row-major
  const uint8_t* w;   // (K/2, N) packed codes
  const float* es;    // (N,)
  const float* eb;    // (N,)
  int8_t* y;          // (M, N)
  int M, N, K;
  int relu;
};

__device__ __forceinline__ int8_t decode_pot(uint32_t c) {
  const int m = c & 7;
  const int mag = m ? (1 << (m - 1)) : 0;
  return (int8_t)((c & 8) ? -mag : mag);
}

__device__ __forceinline__ int8_t requant(int acc, float es, float eb, bool relu) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), es), eb);
  if (relu) v = fmaxf(v, 0.0f);
  v = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  return (int8_t)__float2int_rn(v);
}

// requant with the residual: ((acc * es) + eb) + r * radd, each rounded
__device__ __forceinline__ int8_t requant_resid(int acc, float es, float eb, int8_t r,
                                               float radd, bool relu) {
  float v = __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), es), eb),
                      __fmul_rn(__int2float_rn(r), radd));
  if (relu) v = fmaxf(v, 0.0f);
  v = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  return (int8_t)__float2int_rn(v);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Reduction index of tile column j (0..63) in K-step s of the split-half
// order, or -1 past the end.
__device__ __forceinline__ int k_of(int s, int j, int K) {
  const int kh = K >> 1, r = s * 32 + (j & 31);
  return r < kh ? (j < 32 ? r : kh + r) : -1;
}

union Chunk {
  int4 v;
  uint8_t b[16];
};

template <class Tag>
__global__ void __launch_bounds__(THREADS, 2) qgemm_kernel(const Args p) {
  __shared__ __align__(16) int8_t sA[BM * LDS];  // [m][j]
  __shared__ __align__(16) int8_t sB[BN * LDS];  // [n][j], B transposed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // A loader: rows tid/4 and tid/4 + 64, 16-byte column chunk tid%4
  const int aq = tid & 3;
  const int arow[2] = {m0 + (tid >> 2), m0 + (tid >> 2) + 64};
  // 16-byte loads where every 16 consecutive k of a chunk are contiguous
  // in memory and aligned; the byte path covers the rest
  const bool vec_a = p.K % 16 == 0 && (p.K / 2) % 16 == 0 && (uintptr_t)p.x % 16 == 0;
  const bool vec_b = p.N % 16 == 0 && (uintptr_t)p.w % 16 == 0;
  const int steps = (p.K / 2 + 31) / 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int s = 0; s < steps; ++s) {
    // ---- A tile: sA[m][j] = A[m0 + m][k_of(s, j)] ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int8_t* dst = sA + ((tid >> 2) + 64 * i) * LDS + aq * 16;
      const bool rv = arow[i] < p.M;
      const int8_t* base = p.x + (size_t)arow[i] * p.K;
      if (vec_a) {
        const int k = k_of(s, aq * 16, p.K);
        int4 v = make_int4(0, 0, 0, 0);
        if (rv && k >= 0) v = *reinterpret_cast<const int4*>(base + k);
        *reinterpret_cast<int4*>(dst) = v;
      } else {
#pragma unroll 4
        for (int e = 0; e < 16; ++e) {
          const int k = k_of(s, aq * 16 + e, p.K);
          dst[e] = (rv && k >= 0) ? base[k] : 0;
        }
      }
    }
    // ---- B tile, transposed and decoded: sB[n][j] = B[k_of(s, j)][n0 + n];
    // lane = packed row in this step, warp = 16-column chunk; each byte
    // yields the low-half code (j = lane) and the high-half code (j = 32 +
    // lane) ----
    {
      const int r = s * 32 + lane, nc = warp * 16, n = n0 + nc;
      const bool rv = r < p.K / 2;
      Chunk u;
      u.v = make_int4(0, 0, 0, 0);
      if (vec_b) {
        if (rv && n < p.N) u.v = *reinterpret_cast<const int4*>(p.w + (size_t)r * p.N + n);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          u.b[e] = (rv && n + e < p.N) ? p.w[(size_t)r * p.N + n + e] : 0;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        int8_t* d = sB + (nc + e) * LDS;
        d[lane] = decode_pot(u.b[e] & 15);
        d[32 + lane] = decode_pot(u.b[e] >> 4);
      }
    }
    __syncthreads();

    // ---- tensor cores: two k32 MMA steps over the 64-column tile ----
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* pa = sA + (wm * 64 + i * 16 + g) * LDS + ks * 32 + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(pa);
        af[i][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* pb = sB + (wn * 32 + j * 8 + g) * LDS + ks * 32 + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(pb);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // ---- fused requant epilogue, int8 out ----
  const bool relu = p.relu != 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t * 2;
    float es[2], eb[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      es[c] = col + c < p.N ? p.es[col + c] : 0.0f;
      eb[c] = col + c < p.N ? p.eb[col + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + g + h * 8;
        if (row >= p.M) continue;
        int8_t* out = p.y + (size_t)row * p.N + col;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (col + c < p.N) out[c] = requant(acc[i][j][2 * h + c], es[c], eb[c], relu);
      }
    }
  }
}

template <class Tag>
int launch(const Args& p, void* stream) {
  if (p.M > 0 && p.N > 0) {
    const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
    qgemm_kernel<Tag><<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tf2
