// qmatmul_pot4's main loop for Hopper (sm_90a): Y = requant(X . decode(W)),
// X (M, K) int8 row-major (row stride ldx), W 4-bit power-of-two codes
// given K-major as packed rows (N, ldw) (prepared once at load,
// kernels/shift_matmul.py: prepare_weight): byte r of row n holds the code
// of reduction index r in its low nibble and of K/2 + r in its high one
// (the reference's split-half packing, transposed). int8 out.
//
// A resident slab. A block owns one N-tile of BN channels (and, split along
// K, one run of its K steps) at a time and decodes that tile's codes once
// into shared memory: for each 64-deep K step a [BN][64] B^T tile in
// wgmma's 64-byte swizzled K-major layout (hopper.cuh: swz64), in natural k
// order, zero past K and past N. One 16-byte read of a packed row gives 16
// reduction indices r.. of the low half and 16 of the high half K/2 + r..
// of that channel's B^T row (qgemm.cuh: decode4_lo, decode4_hi), so no
// transpose is needed. The slab fills a step at a time during the first
// M-tile that uses it, each step's codes read a step ahead and decoded
// while the previous step's wgmma runs.
//
// Persistent blocks. The grid is at most the blocks that fit the card;
// block b takes a contiguous run of the work items (N-tile, K split,
// M-tile), the M-tile fastest, so it decodes a slab once and walks many
// M-tiles through it. A streams through a 4-slot cp.async ring in natural
// k order (plain contiguous row chunks, 16-byte copies where K and X's
// address allow, else 4-byte, zero-filled past M and K), 2 steps ahead of
// int8 wgmma (ss: A from the ring, B from the slab; one step of wgmma in
// flight while the next copies are issued). The copy addresses are worked
// out once an M-tile and a step adds its K offset. The ring runs on across
// tiles, so the next tile's A copies are in flight during the epilogue.
//
// Warpgroups of 4 warps, each 64 output rows and all BN columns: BM 128
// (two warpgroups, 256 threads) or 64 (one). BN is 16, 32, 64 or 128,
// fitted to N (kernels/shift_matmul.py: plan_pot4).
//
// Split-K (where K * BN overflows the slab budget, or the grid is under one
// wave): each split's slab holds its K range; every split stores its int32
// sums in its own workspace slice and the last to finish (a per-tile
// counter) adds the others' and runs the epilogue, leaving the counter at
// 0. Integer sums are exact in any order.
//
// Epilogue: each value requantized (requant_byte: requant's function with
// no conversion instruction) into an int8 tile in shared memory, which
// leaves in row chunks of 16 bytes (8, 4, 2 or 1 by N's alignment).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "qgemm.cuh"
#include "qmm_int8.cuh"

namespace tf2 {
namespace pot4 {

constexpr int BK = 64;          // reduction indices per K step
constexpr int STAGES = 4;       // A ring slots
constexpr int LOOK = STAGES - 2;  // steps of copies in flight ahead

struct Params {
  const int8_t* x;    // (M, ldx), K columns read (zero past K where ldx > K)
  const uint8_t* wt;  // (N, ldw) K-major packed rows, ldw % 16 == 0, 16-byte aligned
  const float* es;    // (N,)
  const float* eb;    // (N,)
  int8_t* y;          // (M, N)
  int* ws;            // split-K: int32 partial sums, a tile for each split
  int* counters;      // split-K: splits done, a tile each, 0 between launches
  int M, N, K, ldx, ldw;
  int relu, ovec, small;  // small: 128 * 64 * K <= 2^22 (requant_byte)
  int splits, per;    // K splits, and K steps a split (the slab's depth)
  int mtiles, items;  // M-tiles; work items ntiles * splits * mtiles
};

// Dynamic shared memory: the slab [per][BN][64], the A ring [STAGES][BM][64],
// the output tile [BM][BN + 16], es and eb [BN] each
// (kernels/shift_matmul.py: pot4_smem).
__host__ __device__ constexpr int smem_bytes(int bm, int bn, int per) {
  return per * bn * BK + STAGES * bm * BK + bm * (bn + 16) + 8 * bn;
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Four decoded codes k .. k + 3 of a packed row (k % 4 == 0), zero past K.
__device__ __forceinline__ uint32_t decode_word(const uint8_t* row, int k, int kh, int K) {
  if (k + 4 <= kh) return decode4_lo(ld32(row + k));
  if (k >= kh && k + 4 <= K && ((k - kh) & 3) == 0) return decode4_hi(ld32(row + k - kh));
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int kk = k + b;
    const uint32_t c = kk < kh ? (row[kk] & 15u) : kk < K ? (row[kk - kh] >> 4) : 0u;
    v |= static_cast<uint32_t>(static_cast<uint8_t>(decode_pot(c))) << (8 * b);
  }
  return v;
}

// requant's function (qgemm.cuh: every step rounded on its own, relu,
// round half to even, clip to +-127) without conversion instructions, whose
// rate (16 a clock an SM) would set the time of the wide epilogues: acc
// becomes f32 through the constant 1.5 * 2^23 where |acc| <= 2^22 (small:
// 128 * 64 * K <= 2^22; the bit pattern's carry at +2^22 lands on 2^24,
// which is right), and v + 1.5 * 2^23 rounds the clipped v half to even
// into its low byte (the result's other bytes are not the output's). lo is
// 0 with relu, else -127 (clipping before the rounding gives the same
// integer: the bounds are integers).
__device__ __forceinline__ uint32_t requant_byte(int acc, float es, float eb, float lo,
                                                 bool small) {
  const float f = small ? __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f)
                        : __int2float_rn(acc);
  const float v = fminf(fmaxf(__fadd_rn(__fmul_rn(f, es), eb), lo), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// Blocks an SM the registers must allow: 768 threads (85 registers a
// thread) where BN <= 64, 512 (128 registers) at BN 128
// (kernels/shift_matmul.py: _pot4_blocks_per_sm).
template <int BM, int BN>
constexpr int min_blocks() { return (BN == 128 ? 2 : 3) * (128 / BM); }

template <class Tag, int BM, int BN, int AVEC>
__global__ void __launch_bounds__(2 * BM, min_blocks<BM, BN>()) qmm_pot4(const Params p) {
  constexpr int NT = 2 * BM, NJ = BN / 8, LDO = BN + 16;
  // copies a thread issues a step: A in AVEC-byte pieces
  constexpr int ACPR = BK / AVEC, NA = BM * ACPR / NT;
  static_assert(NA * NT == BM * ACPR, "copies per thread");
  extern __shared__ __align__(1024) int8_t smem[];
  __shared__ int last_split;
  int8_t* const slab = smem;
  int8_t* const ring = smem + p.per * BN * BK;
  int8_t* const so = ring + STAGES * BM * BK;
  float* const s_es = reinterpret_cast<float*>(so + BM * LDO);
  float* const s_eb = s_es + BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp + g;  // this thread's accumulator rows row0, row0 + 8
  const int steps = (p.K + BK - 1) / BK, kh = p.K >> 1;
  const int i_begin = static_cast<int>(static_cast<long long>(blockIdx.x) * p.items / gridDim.x);
  const int i_end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.items / gridDim.x);
  if (i_begin >= i_end) return;

  // This thread's A copies: where each lands in a slot, its reduction
  // index in the step, and, for the M-tile being issued, its source at K
  // step 0 and whether its row exists. A step adds its K offset.
  int a_dst[NA], a_e[NA], a_row[NA];
  long long a_src[NA];
  bool a_ok[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int idx = tid + j * NT, e = (idx % ACPR) * AVEC;
    a_row[j] = idx / ACPR;
    a_dst[j] = swz64(a_row[j], e >> 4) + (e & 15);
    a_e[j] = e;
  }
  // the issue cursor: item ii, its K step is (up to is_end), ring slot qs
  int ii = i_begin, is = 0, is_end = 0, qs = 0;
  auto start_item = [&](int i) {
    const int mt = i % p.mtiles, z = (i / p.mtiles) % p.splits;
    is = z * p.per;
    is_end = min(steps, is + p.per);
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int m = mt * BM + a_row[j];
      a_ok[j] = m < p.M;
      a_src[j] = static_cast<long long>(m) * p.ldx + a_e[j];
    }
  };
  // the next step's copies into its ring slot; one commit group a call
  auto issue = [&]() {
    if (ii < i_end) {
      int8_t* slot = ring + qs * BM * BK;
      const int k0 = is * BK;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const bool in = a_ok[j] && k0 + a_e[j] < p.K;
        cp_async(slot + a_dst[j], in ? p.x + a_src[j] + k0 : p.x, AVEC, in);
      }
      if (++is == is_end && ++ii < i_end) start_item(ii);
    }
    cp_commit();  // empty past the last step: the group count stays uniform
    qs = qs + 1 == STAGES ? 0 : qs + 1;
  };

  // The slab fills step by step while the first M-tile after a slab change
  // is multiplied: step s + 1's codes are read into registers while step s
  // is decoded and stored, before the barrier that publishes it, so the
  // decode overlaps the wgmma of step s - 1 and the reads' latency a step of
  // work. A thread takes NB of a step's BN * 4 16-byte chunks (chunk idx:
  // row idx / 4, codes 16 (idx % 4) .. of the step).
  constexpr int NB = (BN * 4 + NT - 1) / NT;
  uint4 raw[NB];
  int fill_n0 = 0, fill_s0 = 0;  // the slab being filled: its first channel, first K step
  // mode 1: the low nibbles of 16 bytes from k0; 2: the high nibbles of 16
  // bytes from k0 - K/2; 3: word by word (a chunk across K/2 or past K, or a
  // K/2 not a multiple of 16); 0: zero (past N or past K)
  auto chunk_mode = [&](int idx, int s, int& k0) {
    k0 = (fill_s0 + s) * BK + (idx & 3) * 16;
    if (idx >= BN * 4 || fill_n0 + (idx >> 2) >= p.N || k0 >= p.K) return 0;
    if (k0 + 16 <= kh) return 1;
    return k0 >= kh && k0 + 16 <= p.K && ((k0 - kh) & 15) == 0 ? 2 : 3;
  };
  auto row_of = [&](int idx) {
    return p.wt + static_cast<size_t>(fill_n0 + (idx >> 2)) * p.ldw;
  };
  auto load_step = [&](int s) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int idx = tid + u * NT;
      int k0;
      const int mode = chunk_mode(idx, s, k0);
      raw[u] = make_uint4(0, 0, 0, 0);
      if (mode == 1 || mode == 2)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(row_of(idx) + (mode == 1 ? k0 : k0 - kh)));
    }
  };
  auto store_step = [&](int s) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int idx = tid + u * NT;
      if (idx >= BN * 4) break;
      int k0;
      const int mode = chunk_mode(idx, s, k0);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (mode == 1) {
        v = make_uint4(decode4_lo(raw[u].x), decode4_lo(raw[u].y), decode4_lo(raw[u].z),
                       decode4_lo(raw[u].w));
      } else if (mode == 2) {
        v = make_uint4(decode4_hi(raw[u].x), decode4_hi(raw[u].y), decode4_hi(raw[u].z),
                       decode4_hi(raw[u].w));
      } else if (mode == 3) {
        const uint8_t* row = row_of(idx);
        v = make_uint4(decode_word(row, k0, kh, p.K), decode_word(row, k0 + 4, kh, p.K),
                       decode_word(row, k0 + 8, kh, p.K), decode_word(row, k0 + 12, kh, p.K));
      }
      *reinterpret_cast<uint4*>(slab + s * BN * BK + swz64(idx >> 2, idx & 3)) = v;
    }
  };

  start_item(i_begin);
#pragma unroll
  for (int i = 0; i < LOOK; ++i) issue();

  const float lo = p.relu ? 0.0f : -127.0f;
  const bool small = p.small != 0;
  const int ov = p.ovec, cpr_log = __ffs(BN / ov) - 1;
  const int tiles = p.items / p.splits;
  int slab_of = -1, qc = 0;
  for (int i = i_begin; i < i_end; ++i) {
    const int mt = i % p.mtiles, key = i / p.mtiles;
    const int z = key % p.splits, nt = key / p.splits;
    // A new slab replaces one that no wgmma reads any more (each thread
    // waited for its wgmmas, and an epilogue or split-K barrier followed),
    // and es and eb ones that every thread's epilogue has read.
    const bool filling = key != slab_of;
    if (filling) {
      slab_of = key;
      fill_n0 = nt * BN;
      fill_s0 = z * p.per;
      for (int n = tid; n < BN; n += NT) {
        const bool in = fill_n0 + n < p.N;
        s_es[n] = in ? p.es[fill_n0 + n] : 0.0f;
        s_eb[n] = in ? p.eb[fill_n0 + n] : 0.0f;
      }
      load_step(0);
    }
    const int ns = min(steps - z * p.per, p.per);
    int acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0;

    // Step s: its copies have landed (LOOK - 1 groups may still be
    // pending); the barrier publishes them and the slab's step (each thread
    // fenced its writes to the async proxy) and guarantees every warpgroup has
    // retired the wgmmas of two steps before, whose slot the copies issued
    // now refill.
    for (int s = 0; s < ns; ++s) {
      if (filling) {
        store_step(s);
        if (s + 1 < ns) load_step(s + 1);
      }
      cp_wait<LOOK - 1>();
      fence_async_smem();
      __syncthreads();
      issue();
      wgmma_fence();
      const uint64_t da = sw64_desc(ring + qc * BM * BK + (warp >> 2) * 64 * BK);
      const uint64_t db = sw64_desc(slab + s * BN * BK);
      wgmma_ss<BN>(&acc[0][0], da, db);
      wgmma_ss<BN>(&acc[0][0], da + 2, db + 2);
      wgmma_commit();
      wgmma_wait<1>();
      qc = qc + 1 == STAGES ? 0 : qc + 1;
    }
    wgmma_wait<0>();

    const int tile = nt * p.mtiles + mt;
    if (p.splits > 1) {
      auto slice = [&](int zz) { return p.ws + (static_cast<size_t>(zz) * tiles + tile) * BM * BN; };
      int* own = slice(z);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          __stcg(reinterpret_cast<int2*>(own + (row0 + 8 * h) * BN + 8 * j + 2 * t),
                 make_int2(acc[j][2 * h], acc[j][2 * h + 1]));
      __threadfence();
      __syncthreads();
      if (tid == 0) last_split = atomicAdd(p.counters + tile, 1) == p.splits - 1;
      __syncthreads();
      if (!last_split) continue;
      __threadfence();
      for (int zz = 0; zz < p.splits; ++zz) {
        if (zz == z) continue;
        const int* other = slice(zz);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int2 v = __ldcg(reinterpret_cast<const int2*>(
                other + (row0 + 8 * h) * BN + 8 * j + 2 * t));
            acc[j][2 * h] += v.x;
            acc[j][2 * h + 1] += v.y;
          }
      }
      if (tid == 0) p.counters[tile] = 0;
    }

    // ---- epilogue: requantize into the output tile, then 16-byte rows ----
    const int m0 = mt * BM, n0 = nt * BN;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * j + 2 * t;
      const float es0 = s_es[col], es1 = s_es[col + 1], eb0 = s_eb[col], eb1 = s_eb[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v0 = requant_byte(acc[j][2 * h], es0, eb0, lo, small);
        const uint32_t v1 = requant_byte(acc[j][2 * h + 1], es1, eb1, lo, small);
        *reinterpret_cast<uint16_t*>(so + (row0 + 8 * h) * LDO + col) =
            static_cast<uint16_t>(__byte_perm(v0, v1, 0x40));
      }
    }
    __syncthreads();
    for (int idx = tid; idx < (BM << cpr_log); idx += NT) {
      const int row = idx >> cpr_log, c = (idx & ((1 << cpr_log) - 1)) * ov;
      if (m0 + row < p.M && n0 + c < p.N)
        mm::copy_bytes(p.y + static_cast<size_t>(m0 + row) * p.N + n0 + c, so + row * LDO + c, ov);
    }
    // the next write of the output tile follows a step's barrier
  }
  cp_wait<0>();
}

// Grants the kernel the dynamic shared memory a launch asks for (once per
// size), launches, and returns cudaGetLastError().
template <class Tag, int BM, int BN, int AVEC>
int launch(const Params& p, int grid, void* stream) {
  static int granted = 0;
  const int smem = smem_bytes(BM, BN, p.per);
  auto kernel = qmm_pot4<Tag, BM, BN, AVEC>;
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  kernel<<<grid, 2 * BM, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class Tag, int BM, int AVEC>
int launch_bn(const Params& p, int bn, int grid, void* stream) {
  switch (bn) {
    case 16: return launch<Tag, BM, 16, AVEC>(p, grid, stream);
    case 32: return launch<Tag, BM, 32, AVEC>(p, grid, stream);
    case 64: return launch<Tag, BM, 64, AVEC>(p, grid, stream);
    case 128: return launch<Tag, BM, 128, AVEC>(p, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bm 128 or 64, bn 16/32/64/128; x copied 16 bytes at a time where avec is
// 16, else 4 (avec 8 or 4)
template <class Tag>
int launch_plan(const Params& p, int bm, int bn, int avec, int grid, void* stream) {
  if (bm == 128)
    return avec == 16 ? launch_bn<Tag, 128, 16>(p, bn, grid, stream)
                      : launch_bn<Tag, 128, 4>(p, bn, grid, stream);
  if (bm == 64)
    return avec == 16 ? launch_bn<Tag, 64, 16>(p, bn, grid, stream)
                      : launch_bn<Tag, 64, 4>(p, bn, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pot4
}  // namespace tf2
