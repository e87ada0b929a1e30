// The conv kernels' own main loops (qconv.cu): a pipelined implicit GEMM
// for every layer whose C takes 4-byte copies, and a staged-patch kernel
// for the rest (the 3- and 6-channel stems). qgemm.cuh's GEMM loop is not
// used here; requant and mma_s8 are shared with it.
//
// Both read a plan built on the host (kernels/qconv.py: plan): a table
// that maps each K chunk to its tap and channel, so no K loop divides.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "qgemm.cuh"

namespace tf2 {
namespace conv {

constexpr int THREADS = 256;  // a block, but the pipelined kernel at BM 256: 512
constexpr int BK = 64;      // pipelined: reduction indices per K step
constexpr int STAGES = 3;   // pipelined: cp.async ring depth
constexpr int SBK = 32;     // staged: reduction indices per K step
constexpr int SBM = 128;    // staged: output pixels per block
constexpr int SBN = 64;     // staged: output channels per block

struct Params {
  const int8_t* x;    // NHWC (B, H, W, C)
  const uint8_t* w;   // pot4: (K/2, N) packed codes; int8: (K, N)
  const float* es;    // (N,)
  const float* eb;    // (N,)
  int8_t* y;          // NHWC (B, OH, OW, N)
  const int* table;   // the plan's table (kernels/qconv.py: Plan)
  int* ws;            // split-K: int32 partial sums, a tile for each split
  int* counters;      // split-K: splits done, a tile each, 0 between launches
  int B, H, W, C, OH, OW, KH, KW, pad_top, pad_left, N, K, M;
  int relu, avec, bvec, tile_h, tile_w, splits;
};

// ---- PTX wrappers ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16, 8 or 4 bytes; with fill false the destination is zeroed
// (src-size 0) and nothing is read.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool fill) {
  const uint32_t d = smem_u32(dst);
  const int n = fill ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 0xFF in each byte whose bit 7 is set, else 0 (prmt's sign-replicate
// selectors, which __byte_perm does not take)
__device__ __forceinline__ uint32_t byte_signs(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;\n" : "=r"(r) : "r"(x));
  return r;
}

// makes this thread's shared-memory writes (stores, landed cp.async)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x N, s32, the mma.m16n8k32 C layout for each warp's 16 rows) +=
// A (64 x 32) . B^T (N x 32): ss with both operands in shared memory
// (descriptors), rs with A in registers (each warp its 16 rows, the
// mma.m16n8k32 A fragment).
template <int N>
__device__ void wgmma_ss(int* d, uint64_t a, uint64_t b);
template <int N>
__device__ void wgmma_rs(int* d, const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<128>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(int* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(int* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(int* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}
// ---- end of PTX wrappers ----

// Four pot4 codes -> four int8 values (decode_pot's function, four at a
// time): m, the codes' low 3 bits, one in each byte; sign, 0xFF in the
// bytes whose code has bit 3 set. +2^(m-1) and -2^(m-1) come from two
// byte-permute tables (__byte_perm reads 3 bits of each selector nibble),
// picked per byte by the sign.
__device__ __forceinline__ uint32_t decode4(uint32_t m, uint32_t sign) {
  const uint32_t sel = __byte_perm(m | (m >> 4), 0, 0x20);  // nibbles m0 m1 m2 m3
  const uint32_t pos = __byte_perm(0x04020100u, 0x40201008u, sel);
  const uint32_t neg = __byte_perm(0xFCFEFF00u, 0xC0E0F0F8u, sel);
  return (pos & ~sign) | (neg & sign);
}

// The codes in the low and in the high nibbles of four packed bytes.
__device__ __forceinline__ uint32_t decode4_lo(uint32_t c) {
  return decode4(c & 0x07070707u, byte_signs(c << 4));
}
__device__ __forceinline__ uint32_t decode4_hi(uint32_t c) {
  return decode4((c >> 4) & 0x07070707u, byte_signs(c));
}

// 4 x 4 byte transpose: c[i] byte j = r[j] byte i.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ int log2_pow2(int v) { return __ffs(v) - 1; }

// Byte offset of weight row r's first column n0 inside its shared-memory
// row: 0 for aligned copies, else the row's address mod 4 (bvec 0 copies
// the 4-byte words from the aligned address below).
__device__ __forceinline__ int w_shift(const Params& p, int r, int n0) {
  return p.bvec ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(p.w + (size_t)r * p.N + n0) & 3);
}

// cp.async of weight rows r0 .. r0 + rows (those below nvalid) and columns
// n0 .. n0 + BN into dst (row stride ld). Columns past N are not copied
// (their outputs are never stored), nor rows past K (their A columns are
// zero). bvec 16/8/4: aligned chunks; 0: an N whose rows are not 4-byte
// aligned, copied as words from the aligned address below each row's
// start, one word more than BN / 4.
template <int BN, int NT = THREADS>
__device__ __forceinline__ void load_w_rows(const Params& p, int r0, int rows, int nvalid,
                                            int n0, int8_t* dst, int ld) {
  const int vec = p.bvec ? p.bvec : 4;
  const int cpr_log = log2_pow2(BN / vec);
  const int last = (1 << cpr_log) - 1;
  for (int idx = threadIdx.x; idx < (rows << cpr_log); idx += NT) {
    const int i = idx >> cpr_log, q = idx & last, r = r0 + i;
    if (r >= nvalid) continue;
    const uint8_t* row = p.w + (size_t)r * p.N + n0;
    if (p.bvec) {
      if (n0 + q * vec < p.N) cp_async(dst + i * ld + q * vec, row + q * vec, vec, true);
    } else {
      const uintptr_t start = reinterpret_cast<uintptr_t>(row);
      const uintptr_t base = start & ~uintptr_t(3);
      const uintptr_t end = start + min(BN, p.N - n0);
      for (int e = q; e <= q + (q == last); ++e)
        if (base + 4 * e < end)
          cp_async(dst + i * ld + 4 * e, reinterpret_cast<const void*>(base + 4 * e), 4, true);
    }
  }
}

// The output tile so (rows of BN int8 values, stride ld) to memory, 16,
// 8, 4 or 1 byte a store by N's alignment; row_out(row) gives the output
// row's address, or nullptr where the row is past the output.
template <int ROWS, int BN, int NT, class RowOut>
__device__ __forceinline__ void store_tile(const Params& p, const int8_t* so, int ld, int n0,
                                           RowOut row_out) {
  constexpr int CPR = BN / 16, CPR_LOG = CPR == 8 ? 3 : 2;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int row = idx >> CPR_LOG, q = idx & (CPR - 1), col = n0 + 16 * q;
    int8_t* out = row_out(row);
    if (!out || col >= p.N) continue;
    const int8_t* src = so + row * ld + 16 * q;
    out += col;
    if (p.N % 16 == 0) {
      *reinterpret_cast<int4*>(out) = *reinterpret_cast<const int4*>(src);
    } else if (p.N % 8 == 0) {
      for (int e = 0; e < 16 && col + e < p.N; e += 8)
        *reinterpret_cast<int2*>(out + e) = *reinterpret_cast<const int2*>(src + e);
    } else if (p.N % 4 == 0) {
      for (int e = 0; e < 16 && col + e < p.N; e += 4)
        *reinterpret_cast<int*>(out + e) = *reinterpret_cast<const int*>(src + e);
    } else {
      for (int e = 0; e < 16 && col + e < p.N; ++e) out[e] = src[e];
    }
  }
}

// Requantizes the accumulators of a warp tile into so (stride ld): the
// mma.m16n8k32 C fragment, rows g and g + 8, columns 2t and 2t + 1.
template <int MI, int NJ>
__device__ __forceinline__ void requant_tile(const Params& p, const int (&acc)[MI][NJ][4],
                                             int8_t* so, int ld, int row0, int col0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool relu = p.relu != 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = col0 + j * 8 + t * 2;
    float es[2], eb[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool in = n0 + col + c < p.N;
      es[c] = in ? p.es[n0 + col + c] : 0.0f;
      eb[c] = in ? p.eb[n0 + col + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + i * 16 + g + h * 8;
        const uint32_t v0 = static_cast<uint8_t>(requant(acc[i][j][2 * h], es[0], eb[0], relu));
        const uint32_t v1 = static_cast<uint8_t>(requant(acc[i][j][2 * h + 1], es[1], eb[1], relu));
        *reinterpret_cast<uint16_t*>(so + row * ld + col) = static_cast<uint16_t>(v0 | (v1 << 8));
      }
  }
}

// ======================= the pipelined kernel =======================
//
// Shared memory: STAGES x A tile [BM][64] and raw weight rows
// [32 or 64][BN + 16], two decoded B^T tiles [BN][64], then the table
// (steps x BK / avec entries of 8 bytes). A and B^T rows
// are 64 bytes with their four 16-byte chunks XOR-swizzled by
// (row >> 1) & 3, so every ldmatrix phase reads 8 distinct bank groups.

__device__ __forceinline__ int swz64(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// wgmma descriptor of a K-major tile laid out by swz64 from a 512-byte
// aligned base (the 64-byte swizzle): start address, leading offset 16
// bytes (unused when K-major and swizzled), 512 bytes between 8-row groups,
// swizzle mode 2. Adding 2 moves the start 32 bytes along K.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

struct RowInfo {
  long long off;  // offset of input pixel (b, iy0, ix0), channel 0
  int iy0, ix0;   // top-left input tap; iy0 far negative for a row past M
};

// Issues the cp.async copies of K step s's A tile: thread row tid / 4 (+ NT / 4),
// 16-byte column group tid % 4 as 16 / avec copies, each from its table
// entry (input offset, dy, dx), zero-filled where the tap is padding or
// past K.
template <int BM, int NT>
__device__ __forceinline__ void load_a(const Params& p, const RowInfo (&ri)[BM * 4 / NT], int s,
                                       const int2* stab, int8_t* sa) {
  const int g = threadIdx.x & 3, per = 16 / p.avec;
  const int2* tab = stab + s * (BK / p.avec) + g * per;
  for (int u = 0; u < per; ++u) {
    const int2 t = tab[u];  // shared memory, or global in the prologue
    const int dy = t.y >> 16, dx = t.y & 0xFFFF;
#pragma unroll
    for (int pp = 0; pp < BM * 4 / NT; ++pp) {
      const int m = (threadIdx.x >> 2) + NT / 4 * pp;
      const bool in = static_cast<unsigned>(ri[pp].iy0 + dy) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(ri[pp].ix0 + dx) < static_cast<unsigned>(p.W);
      const int8_t* src = in ? p.x + (ri[pp].off + t.x) : p.x;
      cp_async(sa + swz64(m, g) + u * p.avec, src, p.avec, in);
    }
  }
}

// Raw weight rows of K step s (stage raw) -> decoded B^T tile bt [BN][64]:
// 4 x 4 byte blocks transposed in registers; pot4 codes decoded four at a
// time, a packed row's low nibble to column j and its high nibble to
// j + 32 (the split-half order, qgemm.cuh).
template <bool POT4, int BN, int NT>
__device__ __forceinline__ void decode_b(const Params& p, const int8_t* raw, int8_t* bt, int s,
                                         int n0) {
  constexpr int ROWS = POT4 ? 32 : 64, RB = ROWS / 4, RB_LOG = POT4 ? 3 : 4, LD = BN + 16;
  // 4 x 4 byte blocks, each giving 8 words (pot4: 4 columns x low and high
  // nibbles) or 4 (int8); where there are fewer blocks than threads, S
  // threads share a block and thread h of them writes the words w with
  // w % S == h
  constexpr int NBLK = RB * (BN / 4), S = NBLK >= NT ? 1 : NT / NBLK;
#pragma unroll
  for (int it = 0; it < (NBLK + NT - 1) / NT; ++it) {
    const int idx = S > 1 ? threadIdx.x % NBLK : threadIdx.x + it * NT;
    const int h = S > 1 ? threadIdx.x / NBLK : 0;
    const int rb = idx & (RB - 1), cb = idx >> RB_LOG;
    uint32_t r[4], c[4];
    if (p.bvec) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = reinterpret_cast<const uint32_t*>(raw + (rb * 4 + i) * LD)[cb];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rb * 4 + i, o = w_shift(p, s * ROWS + row, n0);
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(raw + row * LD) + cb;
        r[i] = __funnelshift_r(wp[0], wp[1], 8 * o);
      }
    }
    transpose4(r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = cb * 4 + i, j = rb * 4;
      if (POT4) {
        if ((2 * i) % S == h)
          *reinterpret_cast<uint32_t*>(bt + swz64(n, j >> 4) + (j & 15)) = decode4_lo(c[i]);
        if ((2 * i + 1) % S == h)
          *reinterpret_cast<uint32_t*>(bt + swz64(n, 2 + (j >> 4)) + (j & 15)) = decode4_hi(c[i]);
      } else if (i % S == h) {
        *reinterpret_cast<uint32_t*>(bt + swz64(n, j >> 4) + (j & 15)) = c[i];
      }
    }
  }
}

// Patch geometry of the PATCH kernels (qconv.py: patch_geometry): rows and
// pixels a row of the input patch of a tile_h x tile_w output tile, and its
// pixel stride, C plus 16 or 32 bytes so that the stride is an odd number of
// 16-byte chunks and 8 neighbouring pixels fall in 8 distinct bank groups.
struct Patch {
  int ph, pw, cps;
  __host__ __device__ Patch(const Params& p, int sh, int sw)
      : ph((p.tile_h - 1) * sh + p.KH), pw((p.tile_w - 1) * sw + p.KW),
        cps(p.C + (((p.C >> 4) & 1) ? 32 : 16)) {}
  __host__ __device__ int bytes() const { return ph * pw * cps; }
};

// Shared memory of conv_pipe (qconv.py: pipe_smem): the A region (the
// STAGES im2col stages, or the patch and 16 zero bytes; the output tile
// reuses it), STAGES raw weight stages, two B^T tiles, the table; the
// regions 1024-byte aligned.
template <int SH, int SW, bool POT4, int BM, int BN, bool PATCH>
__host__ __device__ inline int pipe_a_region(const Params& p) {
  const int a = PATCH ? Patch(p, SH, SW).bytes() + 16 : STAGES * BM * BK;
  return ((a > BM * (BN + 16) ? a : BM * (BN + 16)) + 1023) / 1024 * 1024;
}

// offset of the B^T tiles: 1024-byte aligned, as their wgmma descriptors
// need
template <int SH, int SW, bool POT4, int BM, int BN, bool PATCH>
__host__ __device__ inline int pipe_bt_offset(const Params& p) {
  return pipe_a_region<SH, SW, POT4, BM, BN, PATCH>(p) +
         (STAGES * (POT4 ? 32 : BK) * (BN + 16) + 1023) / 1024 * 1024;
}

template <int SH, int SW, bool POT4, int BM, int BN, bool PATCH>
__host__ __device__ inline int pipe_smem(const Params& p) {
  const int steps = POT4 ? (p.K / 2 + 31) / 32 : (p.K + BK - 1) / BK;
  const int table = PATCH ? steps * 4 * 4 : steps * (BK / p.avec) * 8;
  return pipe_bt_offset<SH, SW, POT4, BM, BN, PATCH>(p) + 2 * BN * BK + table;
}

// PATCH false: the A tile of each K step is gathered from the image into a
// ring stage (load_a). PATCH true (k x k convs whose C and K/2 take 16-byte
// copies): the block's output tile is tile_h x tile_w pixels of one image,
// the input patch it reads (all C channels) is copied into shared memory
// once, and each lane's ldmatrix row address points straight into the
// patch at its pixel plus the step's tap (table: (dy * PW + dx) * CPS + c
// of each 16-column chunk, or -1 past K): every input byte crosses L2 once
// a block instead of once a tap.
template <int BM>
__host__ __device__ constexpr int pipe_threads() { return BM == 256 ? 512 : 256; }

template <class Tag, int SH, int SW, bool POT4, int BM, int BN, bool PATCH>
__global__ void __launch_bounds__(pipe_threads<BM>(), BM == 256 ? 1 : (BM * BN > 128 * 64 ? 2 : 3))
    conv_pipe(const Params p) {
  // warpgroups of 4 warps: at BM 128 and 256 each takes 64 rows and all BN
  // columns, at BM 64 two take the 64 rows and BN / 2 columns each; a warp
  // holds 16 rows of its warpgroup's 64 x WGN accumulator
  constexpr int NT = pipe_threads<BM>();
  constexpr int WGN = BM == 64 ? BN / 2 : BN, NJ = WGN / 8;
  constexpr int RROWS = POT4 ? 32 : 64, LDB = BN + 16;
  constexpr int A_BYTES = BM * BK, B_BYTES = RROWS * LDB, BT_BYTES = BN * BK;
  extern __shared__ __align__(1024) int8_t smem[];
  int8_t* sA = smem;
  int8_t* sB = sA + pipe_a_region<SH, SW, POT4, BM, BN, PATCH>(p);
  int8_t* sBt = smem + pipe_bt_offset<SH, SW, POT4, BM, BN, PATCH>(p);
  int8_t* sTab = sBt + 2 * BT_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int row0 = (BM == 64 ? 0 : 64 * wg) + 16 * wq, col0 = BM == 64 ? WGN * wg : 0;
  const int n0 = blockIdx.y * BN;
  const int steps = POT4 ? (p.K / 2 + 31) / 32 : (p.K + BK - 1) / BK;
  const int nrows = POT4 ? p.K / 2 : p.K;
  const int tab_bytes = PATCH ? steps * 16 : steps * (BK / p.avec) * 8;

  // where this thread's A rows read: the only divisions. PATCH: the tile's
  // image and origin, and each ldmatrix row's pixel offset in the patch.
  const int m0 = blockIdx.x * BM;
  // split-K: this block's steps [s_begin, s_end) of the tile's K
  const int per = (steps + p.splits - 1) / p.splits;
  const int s_begin = blockIdx.z * per, s_end = min(steps, s_begin + per);
  RowInfo ri[BM * 4 / NT];
  int b = 0, oy0 = 0, ox0 = 0, pix = 0;
  const Patch pg(p, SH, SW);
  if constexpr (PATCH) {
    const int tiles_x = (p.OW + p.tile_w - 1) / p.tile_w;
    const int tiles = tiles_x * ((p.OH + p.tile_h - 1) / p.tile_h);
    b = blockIdx.x / tiles;
    const int t = blockIdx.x - b * tiles;
    oy0 = t / tiles_x * p.tile_h;
    ox0 = (t % tiles_x) * p.tile_w;
    int m = row0 + (lane & 15);
    if (m >= p.tile_h * p.tile_w) m = 0;  // a row past the tile: any finite value
    const int ty = m / p.tile_w, tx = m - ty * p.tile_w;
    pix = (ty * SH * pg.pw + tx * SW) * pg.cps;
  } else {
#pragma unroll
    for (int pp = 0; pp < BM * 4 / NT; ++pp) {
      const int m = m0 + (tid >> 2) + NT / 4 * pp;
      if (m < p.M) {
        const int ohw = p.OH * p.OW;
        const int bb = m / ohw, rem = m - bb * ohw;
        const int oy = rem / p.OW, ox = rem - oy * p.OW;
        ri[pp].iy0 = oy * SH - p.pad_top;
        ri[pp].ix0 = ox * SW - p.pad_left;
        ri[pp].off = ((long long)(bb * p.H + ri[pp].iy0) * p.W + ri[pp].ix0) * p.C;
      } else {
        ri[pp].iy0 = -(1 << 30);
        ri[pp].ix0 = 0;
        ri[pp].off = 0;
      }
    }
  }

  // the first STAGES - 1 steps read the table from global memory: its copy
  // into shared memory lands with step 0
  auto issue = [&](int s, const int2* tab) {
    if (s < s_end) {
      const int slot = s % STAGES;
      if constexpr (!PATCH) load_a<BM, NT>(p, ri, s, tab, sA + slot * A_BYTES);
      load_w_rows<BN, NT>(p, s * RROWS, RROWS, nrows, n0, sB + slot * B_BYTES, LDB);
    }
    cp_commit();  // empty past the last step: the group count stays uniform
  };

  int acc[1][NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[0][j][c] = 0;

  for (int i = tid; i < tab_bytes / 16; i += NT)
    cp_async(sTab + 16 * i, p.table + 4 * i, 16, true);
  if constexpr (PATCH) {
    // the patch, 16 bytes a copy, zero-filled off the image; it lands with
    // step 0
    const int cpp = p.C >> 4, iy_org = oy0 * SH - p.pad_top, ix_org = ox0 * SW - p.pad_left;
    for (int i = tid; i < pg.ph * pg.pw * cpp; i += NT) {
      const int px = i / cpp, cc = i - px * cpp;
      const int pr = px / pg.pw, pc = px - pr * pg.pw;
      const int iy = iy_org + pr, ix = ix_org + pc;
      const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const int8_t* src = in ? p.x + (((long long)(b * p.H + iy) * p.W + ix) * p.C + 16 * cc) : p.x;
      cp_async(sA + px * pg.cps + 16 * cc, src, 16, in);
    }
    if (tid < 4) reinterpret_cast<int*>(sA + pg.bytes())[tid] = 0;
  }
#pragma unroll
  for (int s = s_begin; s < s_begin + STAGES - 1; ++s)
    issue(s, reinterpret_cast<const int2*>(p.table));
  cp_wait<STAGES - 2>();
  __syncthreads();
  decode_b<POT4, BN, NT>(p, sB + (s_begin % STAGES) * B_BYTES, sBt + (s_begin & 1) * BT_BYTES,
                         s_begin, n0);

  // Step s: step s + 1 has landed, s + 2 .. s + STAGES - 1 are in flight.
  // One barrier: it publishes step s + 1's copies and B^T(s) (each thread
  // fences its writes to the async proxy first), and frees the stage and
  // the B^T buffer that the wgmmas of step s - 1 read. The wgmmas of step s
  // run while the threads decode step s + 1; they are waited for before
  // the next barrier.
  for (int s = s_begin; s < s_end; ++s) {
    cp_wait<STAGES - 3>();
    fence_async_smem();
    __syncthreads();
    issue(s + STAGES - 1, reinterpret_cast<const int2*>(sTab));
    const uint64_t db = sw64_desc(sBt + (s & 1) * BT_BYTES + col0 * BK);
    if constexpr (PATCH) {
      const int4 te = reinterpret_cast<const int4*>(sTab)[s];
      uint32_t af[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int off = (lane >> 4) ? (ks ? te.w : te.y) : (ks ? te.z : te.x);
        ldsm_x4(af[ks], off >= 0 ? sA + pix + off : sA + pg.bytes());
      }
      wgmma_fence();
      wgmma_rs<WGN>(&acc[0][0][0], af[0], db);
      wgmma_rs<WGN>(&acc[0][0][0], af[1], db + 2);
    } else {
      const uint64_t da = sw64_desc(sA + (s % STAGES) * A_BYTES + (row0 - 16 * wq) * BK);
      wgmma_fence();
      wgmma_ss<WGN>(&acc[0][0][0], da, db);
      wgmma_ss<WGN>(&acc[0][0][0], da + 2, db + 2);
    }
    wgmma_commit();
    decode_b<POT4, BN, NT>(p, sB + ((s + 1) % STAGES) * B_BYTES,
                           sBt + ((s + 1) & 1) * BT_BYTES, s + 1, n0);
    wgmma_wait<0>();
  }

  // split-K: every split stores its sums in its own slice of the
  // workspace; the last to finish (its count says so, after the others'
  // fenced stores) adds the others' slices to its own sums, leaves the
  // count at 0, and runs the one epilogue. Integer sums are exact in any
  // order.
  cp_wait<0>();
  if (p.splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x, tiles = gridDim.x * gridDim.y;
    const int g = lane >> 2, t = lane & 3;
    auto slice = [&](int z) { return p.ws + ((size_t)z * tiles + tile) * BM * BN; };
    int* own = slice(blockIdx.z);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        __stcg(reinterpret_cast<int2*>(own + (row0 + g + 8 * h) * BN + col0 + 8 * j + 2 * t),
               make_int2(acc[0][j][2 * h], acc[0][j][2 * h + 1]));
    __threadfence();
    __syncthreads();
    int* flag = reinterpret_cast<int*>(sTab);  // the table is read no more
    if (tid == 0) *flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
    for (int z = 0; z < p.splits; ++z) {
      if (z == static_cast<int>(blockIdx.z)) continue;
      const int* other = slice(z);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(
              other + (row0 + g + 8 * h) * BN + col0 + 8 * j + 2 * t));
          acc[0][j][2 * h] += v.x;
          acc[0][j][2 * h + 1] += v.y;
        }
    }
    if (tid == 0) p.counters[tile] = 0;
  }

  // epilogue: requant into shared memory (over the A region), then
  // coalesced stores
  __syncthreads();
  constexpr int LDO = BN + 16;
  requant_tile<1, NJ>(p, acc, smem, LDO, row0, col0, n0);
  __syncthreads();
  store_tile<BM, BN, NT>(p, smem, LDO, n0, [&](int row) -> int8_t* {
    if constexpr (PATCH) {
      if (row >= p.tile_h * p.tile_w) return nullptr;
      const int ty = row / p.tile_w, oy = oy0 + ty, ox = ox0 + row - ty * p.tile_w;
      if (oy >= p.OH || ox >= p.OW) return nullptr;
      return p.y + ((size_t)(b * p.OH + oy) * p.OW + ox) * p.N;
    } else {
      const int m = m0 + row;
      return m < p.M ? p.y + (size_t)m * p.N : nullptr;
    }
  });
}

// ======================= the staged kernel =======================
//
// One block: an output tile of tile_h x tile_w pixels of one image (at most
// SBM) and SBN channels. The input patch the tile reads, ((tile_h - 1) * SH
// + KH) rows of ((tile_w - 1) * SW + KW) pixels, is copied into shared
// memory once with 16-byte cp.async (each row from the aligned address
// below its first byte, padding zeroed after), B^T for the whole K once.
// Each 32-deep K step builds its im2col tile [SBM][32] from the patch,
// one step ahead of the MMAs. Shared memory, in order (qconv.py:
// staged_smem): A double buffer or the output tile, B^T [SBN][Kpad + 16],
// raw weight rows [roundup4(rows)][SBN + 16], the patch [rows][stride],
// the table [Kpad], the patch rows' offsets.

__device__ __forceinline__ int swz32(int row, int chunk) {
  return row * 32 + ((chunk ^ ((row >> 2) & 1)) << 4);
}

template <class Tag, int SH, int SW, bool POT4>
__global__ void __launch_bounds__(THREADS) conv_staged(const Params p) {
  constexpr int WN = 2, WTM = 32, WTN = 32, MI = 2, NJ = 4, LDB = SBN + 16, LDO = SBN + 16;
  constexpr int A_REGION = (2 * SBM * SBK > SBM * LDO) ? 2 * SBM * SBK : SBM * LDO;
  const int kpad = (p.K + SBK - 1) / SBK * SBK, ldt = kpad + 16;
  const int nraw = POT4 ? p.K / 2 : p.K;
  const int th = p.tile_h, tw = p.tile_w;
  const int ph = (th - 1) * SH + p.KH, pw = (tw - 1) * SW + p.KW;
  const int pwb = pw * p.C, ps = (pwb + 32 + 15) / 16 * 16;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sA = smem;
  int8_t* sBt = sA + A_REGION;
  int8_t* sRaw = sBt + SBN * ldt;
  int8_t* sPatch = sRaw + ((nraw + 3) & ~3) * LDB;
  int* sTab = reinterpret_cast<int*>(sPatch + ph * ps);
  int* sRow = sTab + kpad;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int tiles_x = (p.OW + tw - 1) / tw, tiles = tiles_x * ((p.OH + th - 1) / th);
  const int b = blockIdx.x / tiles, trem = blockIdx.x - b * tiles;
  const int oy0 = trem / tiles_x * th, ox0 = (trem % tiles_x) * tw;
  const int n0 = blockIdx.y * SBN;
  const int iy_org = oy0 * SH - p.pad_top, ix_org = ox0 * SW - p.pad_left;
  const int lo_b = max(0, -ix_org) * p.C, hi_b = min(pw, p.W - ix_org) * p.C;

  // ---- prologue: weights, table and patch into shared memory ----
  load_w_rows<SBN>(p, 0, nraw, nraw, n0, sRaw, LDB);
  for (int k = tid; k < kpad; k += THREADS) sTab[k] = __ldg(p.table + k);
  for (int pr = 0; pr < ph; ++pr) {
    const int iy = iy_org + pr;
    const long long g0 = static_cast<long long>(reinterpret_cast<uintptr_t>(p.x)) +
                         ((long long)(b * p.H + iy) * p.W + ix_org) * p.C;
    const int o = static_cast<int>(g0 & 15);
    if (tid == 0) sRow[pr] = pr * ps + o;
    if (iy < 0 || iy >= p.H) continue;
    const long long a0 = (g0 + lo_b) & ~15LL, hi = g0 + hi_b;
    const int chunks = static_cast<int>((hi - a0 + 15) >> 4);
    for (int q = tid; q < chunks; q += THREADS) {
      const long long a = a0 + 16LL * q;
      cp_async(sPatch + pr * ps + o + (a - g0), reinterpret_cast<const void*>(a), 16, true);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // zero the padding (and the neighbours' bytes the aligned copies brought)
  for (int pr = 0; pr < ph; ++pr) {
    const int iy = iy_org + pr;
    const bool row_in = iy >= 0 && iy < p.H;
    int8_t* row = sPatch + sRow[pr];
    for (int e = tid; e < pwb; e += THREADS)
      if (!row_in || e < lo_b || e >= hi_b) row[e] = 0;
  }
  // B^T in natural K order, decoded from shared memory
  for (int idx = tid; idx < nraw * SBN; idx += THREADS) {
    const int r = idx >> 6, n = idx & (SBN - 1);
    const uint8_t v = static_cast<uint8_t>(sRaw[r * LDB + w_shift(p, r, n0) + n]);
    if (POT4) {
      sBt[n * ldt + r] = decode_pot(v & 15);
      sBt[n * ldt + nraw + r] = decode_pot(v >> 4);
    } else {
      sBt[n * ldt + r] = static_cast<int8_t>(v);
    }
  }

  // this thread's im2col row: tile pixel am, 16 columns from 16 * ah
  const int am = tid >> 1, ah = tid & 1;
  const int aty = am / tw, atx = am - aty * tw;
  const bool arow = am < th * tw;
  const int rs = aty * SH, pb = atx * SW * p.C;
  auto build = [&](int s, int8_t* buf) {
    uint32_t wv[4];
    const int* tb = sTab + s * SBK + ah * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tb[q * 4 + e];
        const uint32_t byte = (arow && t >= 0)
            ? static_cast<uint8_t>(sPatch[sRow[rs + (t >> 16)] + pb + (t & 0xFFFF)]) : 0u;
        v |= byte << (8 * e);
      }
      wv[q] = v;
    }
    *reinterpret_cast<uint4*>(buf + swz32(am, ah)) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  __syncthreads();  // patch zeroed, B^T written
  const int ksteps = kpad / SBK;
  build(0, sA);
  __syncthreads();
  for (int s = 0; s < ksteps; ++s) {
    if (s + 1 < ksteps) build(s + 1, sA + ((s + 1) & 1) * SBM * SBK);
    const int8_t* a = sA + (s & 1) * SBM * SBK;
    uint32_t af[MI][4], bf[NJ / 2][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = wm * WTM + i * 16 + (lane & 15);
      ldsm_x4(af[i], a + swz32(m, lane >> 4));
    }
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      const int n = wn * WTN + jp * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(bf[jp], sBt + n * ldt + s * SBK + ((lane >> 3) & 1) * 16);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t b2[2] = {bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]};
        mma_s8(acc[i][j], af[i], b2);
      }
    __syncthreads();
  }

  requant_tile<MI, NJ>(p, acc, sA, LDO, wm * WTM, wn * WTN, n0);
  __syncthreads();
  store_tile<SBM, SBN, THREADS>(p, sA, LDO, n0, [&](int row) -> int8_t* {
    if (row >= th * tw) return nullptr;
    const int ty = row / tw, oy = oy0 + ty, ox = ox0 + row - ty * tw;
    if (oy >= p.OH || ox >= p.OW) return nullptr;
    return p.y + ((size_t)(b * p.OH + oy) * p.OW + ox) * p.N;
  });
}

// ======================= launch =======================

// qconv.py: staged_smem
inline int staged_smem(const Params& p, int sh, int sw, bool pot4) {
  const int kpad = (p.K + SBK - 1) / SBK * SBK, nraw = pot4 ? p.K / 2 : p.K;
  const int ph = (p.tile_h - 1) * sh + p.KH, pw = (p.tile_w - 1) * sw + p.KW;
  const int a_region = 2 * SBM * SBK > SBM * (SBN + 16) ? 2 * SBM * SBK : SBM * (SBN + 16);
  return a_region + SBN * (kpad + 16) + ((nraw + 3) & ~3) * (SBN + 16) +
         ph * ((pw * p.C + 32 + 15) / 16 * 16) + kpad * 4 + (ph * 4 + 15) / 16 * 16;
}

// Sets the kernel's dynamic shared memory limit once, launches, and
// returns cudaGetLastError().
template <class Kernel>
int start(Kernel kernel, int& granted, dim3 grid, int threads, int smem, void* stream,
          const Params& p) {
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class Tag, int SH, int SW, bool POT4, int BM, int BN, bool PATCH>
int launch_pipe(const Params& p, void* stream) {
  static int granted = 48 * 1024;
  const int smem = pipe_smem<SH, SW, POT4, BM, BN, PATCH>(p);
  int blocks = (p.M + BM - 1) / BM;
  if (PATCH)
    blocks = p.B * ((p.OH + p.tile_h - 1) / p.tile_h) * ((p.OW + p.tile_w - 1) / p.tile_w);
  const dim3 grid(blocks, (p.N + BN - 1) / BN, p.splits);
  return start(conv_pipe<Tag, SH, SW, POT4, BM, BN, PATCH>, granted, grid, pipe_threads<BM>(),
               smem, stream, p);
}

template <class Tag, int SH, int SW, bool POT4>
int launch_staged(const Params& p, void* stream) {
  static int granted = 48 * 1024;
  const int smem = staged_smem(p, SH, SW, POT4);
  const int tiles = ((p.OH + p.tile_h - 1) / p.tile_h) * ((p.OW + p.tile_w - 1) / p.tile_w);
  const dim3 grid(p.B * tiles, (p.N + SBN - 1) / SBN);
  return start(conv_staged<Tag, SH, SW, POT4>, granted, grid, THREADS, smem, stream, p);
}

// variant: 0-3 the pipelined tiles 256x128, 128x128, 128x64, 64x64; 4 staged;
// 5-8 the same tiles with the patch (PATCH)
template <class Tag, int SH, int SW, bool POT4>
int launch_variant(const Params& p, int variant, void* stream) {
  switch (variant) {
    case 0: return launch_pipe<Tag, SH, SW, POT4, 256, 128, false>(p, stream);
    case 1: return launch_pipe<Tag, SH, SW, POT4, 128, 128, false>(p, stream);
    case 2: return launch_pipe<Tag, SH, SW, POT4, 128, 64, false>(p, stream);
    case 3: return launch_pipe<Tag, SH, SW, POT4, 64, 64, false>(p, stream);
    case 4: return launch_staged<Tag, SH, SW, POT4>(p, stream);
    case 5: return launch_pipe<Tag, SH, SW, POT4, 256, 128, true>(p, stream);
    case 6: return launch_pipe<Tag, SH, SW, POT4, 128, 128, true>(p, stream);
    case 7: return launch_pipe<Tag, SH, SW, POT4, 128, 64, true>(p, stream);
    case 8: return launch_pipe<Tag, SH, SW, POT4, 64, 64, true>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace conv
}  // namespace tf2
