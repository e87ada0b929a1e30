// Fused stride-1 residual bottleneck block for Hopper (sm_90a); a chain of
// them is one launch per block from one call of the Python wrapper.
//
// Replaces tf2_tpu/kernels/qblocks.py: _qblockchain_kernel (:104, called
// through _qblockchain_call :197 from fused_qblockchain :266). Per block:
//   h  = relu-requant(x . w1)                1x1, int8
//   g  = relu-requant(conv3x3_SAME(h, w2))   zero pads, int8
//   y3 = requant(g . w3)                     1x1, no relu, integer-valued
//   r  = x, or requant(x . wd)               identity or 1x1 downsample
//   y  = clip(rint(relu?(y3 * saso + r * sbso)), +-127)
// The c3 requant and then the add's rounding are the reference's double
// rounding; every product and sum of the epilogues is rounded on its own
// (__fmul_rn, __fadd_rn), so nvcc contracts none into an FMA.
//
// What bounds it on the card: int8 tensor-core operations. A block does
// Cin*Cm + 9*Cm*Cm + Cm*Cout (+ Cin*Cout) multiply-adds per pixel and reads
// and writes Cin + Cout bytes per pixel: hundreds of operations per byte.
//
// What the design does about it: the TPU kernel kept a whole image of the
// whole chain in VMEM. Here one image does not fit shared memory (56x56x320
// bytes at stage 1; stage 4's w2 alone is 2.4 MB), so a CTA owns one image's
// band of R output rows and keeps only that band's intermediates on chip:
//   1. c1 on the band plus a one-row halo above and below into sH, int8,
//      with a zero column left and right and zero rows where the halo falls
//      outside the image (the 3x3's SAME pads);
//   2. the 3x3 from sH into sG, int8, reading the MMA fragments straight
//      out of sH (no im2col copy, no bounds checks);
//   3. c3 from sG, the downsample from x, and the add, straight to y.
// h and g never leave the SM; x is read once for c1 (plus the halo rows)
// and once for the residual; y is written once. Weights stream from global
// memory and L2 in 64-deep K steps, staged transposed in shared memory. The
// MMA is mma.sync m16n8k32 s8 (qgemm.cuh) on 64x64 output tiles, 4 warps of
// 32x32. Pixel rows in sH and sG are round_up(Cm, 32) + 16 bytes long: the
// channel padding lets every 32-deep K slice stay inside one tap, and the
// 16 extra bytes keep the fragment loads free of bank conflicts. Not done
// yet: cp.async/TMA pipelining, wgmma, weights kept as pot4 codes, one
// launch for the whole chain.
#include "qgemm.cuh"

namespace {

struct qblockchain;  // kernel tag, named after the wrapper

constexpr int TM = 64;         // output rows (pixels) of a tile
constexpr int TN = 64;         // output channels of a tile
constexpr int TK = 64;         // reduction indices per staged step
constexpr int LDT = TK + 16;   // staged tile row stride (80 B): conflict-free
constexpr int NT = 128;        // 4 warps as 2 (M) x 2 (N), each 32 x 32

struct Params {
  const int8_t* x;             // (B, H, W, Cin)
  const int8_t *w1, *w2, *w3;  // (Cin, Cm), (3, 3, Cm, Cm), (Cm, Cout)
  const int8_t* wd;            // (Cin, Cout), or null
  const float *es1, *eb1, *es2, *eb2, *es3, *eb3, *esd, *ebd;
  int8_t* y;                   // (B, H, W, Cout)
  int H, W, Cin, Cm, Cout;
  int CmP, PS, R;              // Cm rounded up to 32; pixel row bytes; band rows
  int down, relu;
  float saso, sbso;
};

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Tile row of fragment (i, h) and tile column of accumulator (j, c) for this
// thread: acc[i][j][2 * h + c] is element (row(i, h), col(j, c)).
__device__ __forceinline__ int frag_row(int i, int h) {
  return ((threadIdx.x >> 5) >> 1) * 32 + i * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}

__device__ __forceinline__ int frag_col(int j, int c) {
  return ((threadIdx.x >> 5) & 1) * 32 + j * 8 + (threadIdx.x & 3) * 2 + c;
}

__device__ __forceinline__ void zero(int (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// sA[m][j] = a[m0 + m][k0 + j] of a row-major (M, K) int8 matrix, zero past
// either edge. vec: K % 16 == 0 and a 16-byte aligned.
__device__ __forceinline__ void stage_a(int8_t* sA, const int8_t* a, int M, int K,
                                        int m0, int k0, bool vec) {
  const int q = threadIdx.x & 3, k = k0 + q * 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = (threadIdx.x >> 2) + 32 * i;
    int8_t* dst = sA + m * LDT + q * 16;
    const bool rv = m0 + m < M;
    const int8_t* src = a + (size_t)(m0 + m) * K + k;
    if (vec) {
      int4 v = make_int4(0, 0, 0, 0);
      if (rv && k < K) v = *reinterpret_cast<const int4*>(src);
      *reinterpret_cast<int4*>(dst) = v;
    } else {
#pragma unroll 4
      for (int e = 0; e < 16; ++e) dst[e] = (rv && k + e < K) ? src[e] : 0;
    }
  }
}

// sB[n][j] = w[krow(k0 + j)][n0 + n] of a row-major (rows, N) int8 weight,
// zero where krow gives -1 or past N. vec: N % 16 == 0 and w 16-byte aligned.
template <class KRow>
__device__ __forceinline__ void stage_b(int8_t* sB, const int8_t* w, int N, int k0,
                                        int n0, KRow krow, bool vec) {
  const int j = threadIdx.x & 63, row = krow(k0 + j);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int nc = ((threadIdx.x >> 6) + 2 * h) * 16, n = n0 + nc;
    tf2::Chunk u;
    u.v = make_int4(0, 0, 0, 0);
    if (row >= 0) {
      const int8_t* src = w + (size_t)row * N + n;
      if (vec) {
        if (n < N) u.v = *reinterpret_cast<const int4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) u.b[e] = n + e < N ? src[e] : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) sB[(nc + e) * LDT + j] = (int8_t)u.b[e];
  }
}

// acc += A[:, slice] . sB[:, slice] for one 32-deep K slice. pa[i][h] points
// at this slice's first byte in A row frag_row(i, h); sBk at the slice's
// first column of sB.
__device__ __forceinline__ void mma_k32(int (&acc)[2][4][4], const int8_t* const (&pa)[2][2],
                                        const int8_t* sBk) {
  const int t4 = (threadIdx.x & 3) * 4;
  uint32_t af[2][4], bf[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    af[i][0] = ld32(pa[i][0] + t4);
    af[i][1] = ld32(pa[i][1] + t4);
    af[i][2] = ld32(pa[i][0] + 16 + t4);
    af[i][3] = ld32(pa[i][1] + 16 + t4);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // B fragment column n = warp's 32-column half + j * 8 + lane / 4
    const int n = ((threadIdx.x >> 5) & 1) * 32 + j * 8 + ((threadIdx.x & 31) >> 2);
    const int8_t* pb = sBk + n * LDT + t4;
    bf[j][0] = ld32(pb);
    bf[j][1] = ld32(pb + 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tf2::mma_s8(acc[i][j], af[i], bf[j]);
}

// acc = A . B for a (M, K) x-pixel matrix staged through sA and a (K, N)
// weight: the tile at (m0, n0).
__device__ __forceinline__ void gemm_staged(int (&acc)[2][4][4], int8_t* sA, int8_t* sB,
                                            const int8_t* a, const int8_t* w, int M, int K,
                                            int N, int m0, int n0, bool vec_a) {
  const bool vec_b = N % 16 == 0 && aligned16(w);
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += TK) {
    stage_a(sA, a, M, K, m0, k0, vec_a);
    stage_b(sB, w, N, k0, n0, [K](int k) { return k < K ? k : -1; }, vec_b);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int8_t* pa[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) pa[i][h] = sA + frag_row(i, h) * LDT + ks * 32;
      mma_k32(acc, pa, sB + ks * 32);
    }
    __syncthreads();
  }
}

template <class Tag>
__global__ void __launch_bounds__(NT) qblock_kernel(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int R = p.R, H = p.H, W = p.W, WP = W + 2, PS = p.PS, CmP = p.CmP;
  int8_t* sH = smem;                        // (R + 2) x (W + 2) pixels
  int8_t* sG = sH + (R + 2) * WP * PS;      // R x W pixels
  int8_t* sA = sG + R * W * PS;             // TM x LDT
  int8_t* sB = sA + TM * LDT;               // TN x LDT
  const int img = blockIdx.y, r0 = blockIdx.x * R;
  const int rows = min(R, H - r0);                          // output rows
  const int ylo = max(r0 - 1, 0), yhi = min(r0 + rows + 1, H);  // c1 rows
  const bool vec_x = p.Cin % 16 == 0 && aligned16(p.x);
  int acc[2][4][4];

  // zero sH: the halo rows outside the image, the pad columns, and the
  // channel padding the 3x3 reads (against zero weights)
  for (int i = threadIdx.x; i < (R + 2) * WP * PS / 16; i += NT)
    reinterpret_cast<int4*>(sH)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // ---- 1. c1 on image rows [ylo, yhi) into sH ----
  {
    const int M = (yhi - ylo) * W;
    const int8_t* a = p.x + ((size_t)img * H + ylo) * W * p.Cin;
    for (int m0 = 0; m0 < M; m0 += TM)
      for (int n0 = 0; n0 < p.Cm; n0 += TN) {
        gemm_staged(acc, sA, sB, a, p.w1, M, p.Cin, p.Cm, m0, n0, vec_x);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + frag_row(i, h);
            if (m >= M) continue;
            // sH row 0 is image row r0 - 1, sH column 0 is image column -1
            int8_t* out = sH + ((ylo + m / W - r0 + 1) * WP + m % W + 1) * PS;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int n = n0 + frag_col(j, c);
                if (n < p.Cm) out[n] = tf2::requant(acc[i][j][2 * h + c], p.es1[n], p.eb1[n], true);
              }
          }
      }
  }
  __syncthreads();

  // ---- 2. 3x3 SAME conv from sH into sG; K runs over (tap, channel < CmP) ----
  {
    const int M = rows * W, K = 9 * CmP, Cm = p.Cm;
    const bool vec_b = Cm % 16 == 0 && aligned16(p.w2);
    const auto krow = [CmP, Cm](int k) {
      const int tap = k / CmP, c = k - tap * CmP;
      return tap < 9 && c < Cm ? tap * Cm + c : -1;
    };
    for (int m0 = 0; m0 < M; m0 += TM)
      for (int n0 = 0; n0 < Cm; n0 += TN) {
        // sH byte offset of tap (0, 0) for each fragment row; rows past the
        // band repeat its last pixel and are not stored
        int base[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = min(m0 + frag_row(i, h), M - 1);
            base[i][h] = ((m / W) * WP + m % W) * PS;
          }
        zero(acc);
        for (int k0 = 0; k0 < K; k0 += TK) {
          stage_b(sB, p.w2, Cm, k0, n0, krow, vec_b);
          __syncthreads();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int kk = k0 + ks * 32;
            if (kk >= K) break;
            const int tap = kk / CmP;
            const int off = ((tap / 3) * WP + tap % 3) * PS + kk - tap * CmP;
            const int8_t* pa[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) pa[i][h] = sH + base[i][h] + off;
            mma_k32(acc, pa, sB + ks * 32);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + frag_row(i, h);
            if (m >= M) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int n = n0 + frag_col(j, c);
                if (n < Cm) sG[m * PS + n] = tf2::requant(acc[i][j][2 * h + c], p.es2[n], p.eb2[n], true);
              }
          }
      }
  }
  __syncthreads();

  // ---- 3. c3 from sG, the residual, the add; out to y ----
  {
    const int M = rows * W, Cm = p.Cm, Cout = p.Cout;
    const size_t pix0 = ((size_t)img * H + r0) * W;  // the band's first pixel
    const int8_t* xb = p.x + pix0 * p.Cin;
    const bool vec_b = Cout % 16 == 0 && aligned16(p.w3);
    for (int m0 = 0; m0 < M; m0 += TM)
      for (int n0 = 0; n0 < Cout; n0 += TN) {
        uint32_t rq[2][4];  // the downsample's int8 results, 4 to a word
        if (p.down) {
          gemm_staged(acc, sA, sB, xb, p.wd, M, p.Cin, Cout, m0, n0, vec_x);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              rq[i][j] = 0;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = n0 + frag_col(j, e & 1);
                const int8_t v = n < Cout ? tf2::requant(acc[i][j][e], p.esd[n], p.ebd[n], false) : 0;
                rq[i][j] |= (uint32_t)(uint8_t)v << (8 * e);
              }
            }
        }
        const int8_t* rowp[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) rowp[i][h] = sG + min(m0 + frag_row(i, h), M - 1) * PS;
        zero(acc);
        for (int k0 = 0; k0 < CmP; k0 += TK) {
          stage_b(sB, p.w3, Cout, k0, n0, [Cm](int k) { return k < Cm ? k : -1; }, vec_b);
          __syncthreads();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int kk = k0 + ks * 32;
            if (kk >= CmP) break;
            const int8_t* pa[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) pa[i][h] = rowp[i][h] + kk;
            mma_k32(acc, pa, sB + ks * 32);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + frag_row(i, h);
            if (m >= M) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int n = n0 + frag_col(j, c), e = 2 * h + c;
                if (n >= Cout) continue;
                const float y3 = tf2::requant(acc[i][j][e], p.es3[n], p.eb3[n], false);
                const float r = p.down ? (float)(int8_t)(rq[i][j] >> (8 * e))
                                       : (float)xb[(size_t)m * p.Cin + n];
                float v = __fadd_rn(__fmul_rn(y3, p.saso), __fmul_rn(r, p.sbso));
                if (p.relu) v = fmaxf(v, 0.0f);
                v = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
                p.y[(pix0 + m) * Cout + n] = (int8_t)__float2int_rn(v);
              }
          }
      }
  }
}

}  // namespace

// One bottleneck block. x (B, H, W, Cin) int8; w1 (Cin, Cm), w2 (3, 3, Cm,
// Cm) HWIO, w3 (Cm, Cout), wd (Cin, Cout) int8 (null unless down); es*/eb*
// f32 per output channel; y (B, H, W, Cout) int8, not overlapping x. rows:
// output rows per CTA. Returns the CUDA error of the attribute call or the
// launch.
extern "C" int tf2_qblock(const void* x, const void* w1, const void* es1, const void* eb1,
                          const void* w2, const void* es2, const void* eb2, const void* w3,
                          const void* es3, const void* eb3, const void* wd, const void* esd,
                          const void* ebd, void* y, int b, int h, int w, int cin, int cm,
                          int cout, int down, int relu, float saso, float sbso, int rows,
                          void* stream) {
  Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.w3 = static_cast<const int8_t*>(w3);
  p.wd = static_cast<const int8_t*>(wd);
  p.es1 = static_cast<const float*>(es1);
  p.eb1 = static_cast<const float*>(eb1);
  p.es2 = static_cast<const float*>(es2);
  p.eb2 = static_cast<const float*>(eb2);
  p.es3 = static_cast<const float*>(es3);
  p.eb3 = static_cast<const float*>(eb3);
  p.esd = static_cast<const float*>(esd);
  p.ebd = static_cast<const float*>(ebd);
  p.y = static_cast<int8_t*>(y);
  p.H = h;
  p.W = w;
  p.Cin = cin;
  p.Cm = cm;
  p.Cout = cout;
  p.CmP = (cm + 31) / 32 * 32;
  p.PS = p.CmP + 16;
  p.R = rows;
  p.down = down;
  p.relu = relu;
  p.saso = saso;
  p.sbso = sbso;
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const int smem = (rows + 2) * (w + 2) * p.PS + rows * w * p.PS + 2 * TM * LDT;
  const cudaError_t err = cudaFuncSetAttribute(
      qblock_kernel<qblockchain>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h + rows - 1) / rows, b);
  qblock_kernel<qblockchain><<<grid, NT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
