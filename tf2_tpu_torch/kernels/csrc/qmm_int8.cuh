// qmatmul_int8's main loop for Hopper (sm_90a): Y = requant(X . W (+ R)),
// X (M, K) int8 row-major, W given K-major as W^T rows (N, ldw) (prepared
// once at load, kernels/shift_matmul.py: prepare_weight), int8 out.
//
// A block of two warpgroups computes a BM x BN output tile
// (kernels/shift_matmul.py: plan picks 128x128, 128x64, 64x128 or 64x64 per
// shape). Its K runs in 64-deep steps through a ring of shared-memory slots
// (6, as many as fit two blocks an SM: stages), each holding the step's A
// tile and W^T tile in wgmma's 64-byte swizzled K-major layout
// (hopper.cuh: swz64), both filled straight from global memory by 16-byte
// cp.async (A by 4 bytes where K or X's address is not 16-byte aligned),
// zero-filled past M, N and K. The weight needs no per-step transpose: its
// rows are K-major in memory. Each thread works out its copies' addresses
// once; a step adds its K offset (the copies' address arithmetic, not the
// copies or the MMAs, set the time of a first version: PERF.md).
// LOOK = stages - 2 steps of copies are in flight ahead of the step being
// multiplied, and one step of wgmma (m64nNk32 s8, A and B from shared
// memory) runs while the next step's copies are issued: a slot is refilled
// only after every warpgroup has waited for the wgmmas that read it two
// steps before.
//
// Warpgroups of 4 warps: at BM 128 each takes 64 rows and all BN columns,
// at BM 64 each takes the 64 rows and BN / 2 columns.
//
// Split-K (plan: grids under one wave, the fc and b1's small M): blockIdx.z
// takes a run of the K steps; every split stores its int32 sums in its own
// workspace slice, the last one to finish (a per-tile counter) adds the
// others' and runs the epilogue, leaving the counter at 0. Integer sums are
// exact in any order.
//
// Epilogue, from the accumulators: the residual tile (if any) is read into
// shared memory in 16-byte chunks (8, 4, 2 or 1 by N's alignment), each
// value requantized (qgemm.cuh: requant / requant_resid, every step rounded
// on its own) into an int8 tile in shared memory, which leaves in 16-byte
// row chunks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "qgemm.cuh"

namespace tf2 {
namespace mm {

constexpr int KSUB = 1;        // 64-deep sub-tiles a ring slot (a K step)
constexpr int BK = 64 * KSUB;  // reduction indices per K step
constexpr int MAX_STAGES = 6;  // ring slots, at most
constexpr int NT = 256;        // threads a block: two warpgroups
constexpr int ROOM = 232448 / 2 - 1024;  // shared memory of one of two blocks an SM

// Ring slots of a tile: as many as fit two blocks an SM, up to MAX_STAGES.
template <int BM, int BN>
__host__ __device__ constexpr int stages() {
  return ROOM / ((BM + BN) * BK) < MAX_STAGES ? ROOM / ((BM + BN) * BK) : MAX_STAGES;
}

struct Params {
  const int8_t* x;    // (M, K), row stride K
  const int8_t* wt;   // (N, ldw) K-major weight rows, ldw % 16 == 0, 16-byte aligned
  const float* es;    // (N,)
  const float* eb;    // (N,)
  const int8_t* r;    // the residual (M, N), or null
  float radd;
  int8_t* y;          // (M, N)
  int* ws;            // split-K: int32 partial sums, a tile for each split
  int* counters;      // split-K: splits done, a tile each, 0 between launches
  int M, N, K, ldw;
  int relu, avec, ovec, splits;
};

template <int BM, int BN>
__host__ __device__ constexpr int ring_bytes() { return stages<BM, BN>() * (BM + BN) * BK; }

// dynamic shared memory of a block: the ring; the epilogue's output and
// residual tiles [BM][BN + 16] reuse it
template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<BM, BN>() > 2 * BM * (BN + 16) ? ring_bytes<BM, BN>()
                                                    : 2 * BM * (BN + 16);
}

// Copies of v bytes (16, 8, 4, 2, 1) between a global row and shared memory.
__device__ __forceinline__ void copy_bytes(int8_t* dst, const int8_t* src, int v) {
  if (v == 16)
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  else if (v == 8)
    *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
  else if (v == 4)
    *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src);
  else if (v == 2)
    *reinterpret_cast<short*>(dst) = *reinterpret_cast<const short*>(src);
  else
    *dst = *src;
}

template <class Tag, int BM, int BN, int AVEC, bool RESID>
__global__ void __launch_bounds__(NT, 2) qmm_int8(const Params p) {
  constexpr int STAGES = stages<BM, BN>(), LOOK = STAGES - 2;
  constexpr int WGN = BM == 64 ? BN / 2 : BN, NJ = WGN / 8;
  constexpr int A_BYTES = BM * BK, SLOT = (BM + BN) * BK, LDO = BN + 16;
  // copies a thread issues a step: A in AVEC-byte pieces, W^T in 16
  constexpr int ACPR = 64 / AVEC, NA = BM * ACPR * KSUB / NT, NB = BN * 4 * KSUB / NT;
  static_assert(NA * NT == BM * ACPR * KSUB && NB * NT == BN * 4 * KSUB, "copies per thread");
  extern __shared__ __align__(1024) int8_t smem[];
  __shared__ int last_split;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  // this thread's accumulator rows row0 + g (+ 8) and columns col0 + 8 j + 2 t (+ 1)
  const int row0 = (BM == 64 ? 0 : 64 * wg) + 16 * wq, col0 = BM == 64 ? WGN * wg : 0;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps = (p.K + BK - 1) / BK;
  const int per = (steps + p.splits - 1) / p.splits;
  const int s_begin = blockIdx.z * per, s_end = min(steps, s_begin + per);

  // This thread's copies, worked out once: where each lands in a slot, the
  // source offset at K step 0, its reduction index in the step, and whether
  // its row exists. A step adds s * BK to the sources.
  int a_dst[NA], a_e[NA], b_dst[NB], b_e[NB];
  long long a_src[NA], b_src[NB];
  bool a_ok[NA], b_ok[NB];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int idx = tid + j * NT, u = idx / (BM * ACPR), rem = idx % (BM * ACPR);
    const int row = rem / ACPR, e = (rem % ACPR) * AVEC;
    a_dst[j] = u * BM * 64 + swz64(row, e >> 4) + (e & 15);
    a_e[j] = 64 * u + e;
    a_ok[j] = m0 + row < p.M;
    a_src[j] = (long long)(m0 + row) * p.K + a_e[j];
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int idx = tid + j * NT, row = idx / (4 * KSUB), q = idx % (4 * KSUB);
    b_dst[j] = A_BYTES + (q >> 2) * BN * 64 + swz64(row, q & 3);
    b_e[j] = 16 * q;
    b_ok[j] = n0 + row < p.N;
    b_src[j] = (long long)(n0 + row) * p.ldw + b_e[j];
  }

  // the copies of K step s into its ring slot; one commit group a call
  auto issue = [&](int s) {
    if (s < s_end) {
      int8_t* slot = smem + ((s - s_begin) % STAGES) * SLOT;
      const int k0 = s * BK;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const bool in = a_ok[j] && k0 + a_e[j] < p.K;
        cp_async(slot + a_dst[j], in ? p.x + a_src[j] + k0 : p.x, AVEC, in);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const bool in = b_ok[j] && k0 + b_e[j] < p.K;
        cp_async(slot + b_dst[j], in ? p.wt + b_src[j] + k0 : p.wt, 16, in);
      }
    }
    cp_commit();  // empty past the last step: the group count stays uniform
  };

  int acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;

#pragma unroll
  for (int i = 0; i < LOOK; ++i) issue(s_begin + i);

  // Step s: its copies have landed (LOOK - 1 groups may still be pending);
  // the barrier publishes them (each thread fenced its cp.async writes to
  // the async proxy) and guarantees every warpgroup has retired the
  // wgmmas of step s - 2, whose slot step s + LOOK then refills.
  for (int s = s_begin; s < s_end; ++s) {
    cp_wait<LOOK - 1>();
    fence_async_smem();
    __syncthreads();
    issue(s + LOOK);
    const int8_t* sa = smem + ((s - s_begin) % STAGES) * SLOT;
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < KSUB; ++u) {
      const uint64_t da = sw64_desc(sa + u * BM * 64 + (row0 - 16 * wq) * 64);
      const uint64_t db = sw64_desc(sa + A_BYTES + u * BN * 64 + col0 * 64);
      wgmma_ss<WGN>(&acc[0][0], da, db);
      wgmma_ss<WGN>(&acc[0][0], da + 2, db + 2);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  if (p.splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x, tiles = gridDim.x * gridDim.y;
    auto slice = [&](int z) { return p.ws + ((size_t)z * tiles + tile) * BM * BN; };
    int* own = slice(blockIdx.z);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        __stcg(reinterpret_cast<int2*>(own + (row0 + g + 8 * h) * BN + col0 + 8 * j + 2 * t),
               make_int2(acc[j][2 * h], acc[j][2 * h + 1]));
    __threadfence();
    __syncthreads();
    if (tid == 0) last_split = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!last_split) return;
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
          acc[j][2 * h] += v.x;
          acc[j][2 * h + 1] += v.y;
        }
    }
    if (tid == 0) p.counters[tile] = 0;
  }

  // ---- epilogue: the ring is free ----
  __syncthreads();
  int8_t* so = smem;              // [BM][LDO] int8 out
  int8_t* sr = smem + BM * LDO;   // [BM][LDO] the residual
  const int ov = p.ovec, cpr = BN / ov;
  if (RESID) {
    for (int idx = tid; idx < BM * cpr; idx += NT) {
      const int row = idx / cpr, c = (idx - row * cpr) * ov;
      if (m0 + row < p.M && n0 + c < p.N)
        copy_bytes(sr + row * LDO + c, p.r + (size_t)(m0 + row) * p.N + n0 + c, ov);
    }
    __syncthreads();
  }
  const bool relu = p.relu != 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    float es[2], eb[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool in = n0 + col + c < p.N;
      es[c] = in ? p.es[n0 + col + c] : 0.0f;
      eb[c] = in ? p.eb[n0 + col + c] : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      uint32_t v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[c] = static_cast<uint8_t>(
            RESID ? requant_resid(acc[j][2 * h + c], es[c], eb[c], sr[row * LDO + col + c],
                                  p.radd, relu)
                  : requant(acc[j][2 * h + c], es[c], eb[c], relu));
      *reinterpret_cast<uint16_t*>(so + row * LDO + col) = static_cast<uint16_t>(v[0] | (v[1] << 8));
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * cpr; idx += NT) {
    const int row = idx / cpr, c = (idx - row * cpr) * ov;
    if (m0 + row < p.M && n0 + c < p.N)
      copy_bytes(p.y + (size_t)(m0 + row) * p.N + n0 + c, so + row * LDO + c, ov);
  }
}

// Sets the kernel's dynamic shared memory limit once, launches, and
// returns cudaGetLastError().
template <class Tag, int BM, int BN, int AVEC, bool RESID>
int launch(const Params& p, void* stream) {
  static bool granted = false;
  constexpr int smem = smem_bytes<BM, BN>();
  auto kernel = qmm_int8<Tag, BM, BN, AVEC, RESID>;
  if (!granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = true;
  }
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, p.splits);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// tile: 0-3 the tiles 128x128, 128x64, 64x128, 64x64; x copied 16 bytes
// at a time where avec is 16, else 4 (avec 8 or 4)
template <class Tag, int AVEC, bool RESID>
int launch_tile(const Params& p, int tile, void* stream) {
  switch (tile) {
    case 0: return launch<Tag, 128, 128, AVEC, RESID>(p, stream);
    case 1: return launch<Tag, 128, 64, AVEC, RESID>(p, stream);
    case 2: return launch<Tag, 64, 128, AVEC, RESID>(p, stream);
    case 3: return launch<Tag, 64, 64, AVEC, RESID>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Tag>
int launch_plan(const Params& p, int tile, void* stream) {
  if (p.avec == 16)
    return p.r ? launch_tile<Tag, 16, true>(p, tile, stream)
               : launch_tile<Tag, 16, false>(p, tile, stream);
  return p.r ? launch_tile<Tag, 4, true>(p, tile, stream)
             : launch_tile<Tag, 4, false>(p, tile, stream);
}

}  // namespace mm
}  // namespace tf2
