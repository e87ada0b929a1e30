// Fused small-cin stride-2 stem conv for Hopper: NHWC f32 (quantized here
// by a scale) or int8 image in, int8 NHWC out:
//   x_q = clip(rint(x / scale), +-127)        (f32 input; IEEE division)
//   acc = sum over (dy, dx, c) of x_q[2 oy + dy - pad_top, 2 ox + dx - pad_left, c]
//                                  * w[dy, dx, c, n]                int32, exact
//   y   = clip(rint(max?(f32(acc) * es + eb, 0)), +-127)
//
// Replaces tf2_tpu/kernels/qstem.py:
//   tf2_qstem  <- _qstem_kernel (:144, called through _qstem_call :184)
// On the card the Engine runs every zoo CNN's fused stem here (the node
// fuse_stem_quantize leaves, routed at load by Engine.stem_plan), as the
// reference quantizes its stem inside one XLA fusion.
//
// What bounds it on the card: memory bytes. At the ResNet-50 stem (7x7,
// cin 3 -> 64, 224x224, batch 64) it reads a 38.5 MB f32 image and writes
// a 51.4 MB int8 output, 0.027 ms at 3.35 TB/s, against 0.0076 ms of int8
// tensor-core work (K = 147, inside the image). Next come instructions: a
// requant for each of the 51.4 M outputs and a quantize for each of the
// 9.6 M inputs.
//
// What the design does about it (the launch: kernels/qstem.py: plan):
// - Two warpgroups a block, two blocks an SM: a producer and a consumer,
//   meeting at named barriers. While the consumer runs the MMAs and the
//   epilogue of a step's 64-pixel tiles, the producer copies and quantizes
//   the next step's rows.
// - Every input byte leaves HBM once. Persistent blocks each walk a run of
//   output rows of one image, a step of `rs` rows at a time. The f32 rows
//   come in whole into a staging ring `depth` steps ahead, a bulk copy a
//   row completing on the slot's mbarrier (cp.async of 4 bytes a thread
//   where a row is not a multiple of 16 bytes), and are quantized once an
//   element into a ring of int8 rows that keeps the k - 2 input rows
//   consecutive steps share, and two steps' rows, the one the consumer
//   reads and the one the producer writes. The quantize is
//   certified: x * f32(1 / scale), rounded by adding 1.5 * 2^23, is taken
//   where it lies farther than 2^-14 from every half-integer (it is within
//   |x / scale| * 2^-22 of the IEEE quotient, so both round alike), else
//   the IEEE division (__fdiv_rn, rintf).
// - No patch tile and no division in an inner loop. K runs in HWIO's own
//   (dy, dx, c) order, each dy's kw * C taps (21 bytes at 7x7x3) padded
//   with zero weights to one 32-deep k-step. An output pixel's taps of row
//   dy are then contiguous bytes of ring row dy from byte 2 ox C, so the A
//   fragment is read straight from the ring: each ring row is kept twice,
//   the second copy shifted by 2 bytes, which makes every 4-byte fragment
//   word aligned in one of them (2 ox C is even). The padded taps meet
//   other pixels' bytes against zero weights.
// - int8 wgmma: the consumer takes 64 of a step's pixels at a time, its
//   A fragments in registers (one k-step for each dy), B, the weight,
//   resident in shared memory in wgmma's 64-byte swizzled K-major layout
//   (two dy a 64-byte row), loaded once a block from the weight prepared at
//   load ((N, KH * 32) int8 rows, kernels/qstem.py: prepare_weight).
// - A 16-byte epilogue: B's columns are loaded permuted within each chunk,
//   so that a lane's accumulators are 16 consecutive output channels of a
//   pixel (8 where the chunk is 32 wide); requant's function without
//   conversion instructions (the accumulators start at the bits of
//   1.5 * 2^23; |acc| <= 128 * 128 * 196 < 2^22) packs them into one
//   16-byte word, es and eb come from shared memory, and the word goes
//   straight to the NHWC output: the four lanes of a quad write a pixel's
//   64 channels, a warp's store 8 consecutive pixels, 512 contiguous bytes
//   (byte stores where N is not a multiple of 16). A staging tile in shared
//   memory (tried first) only added a barrier and a copy: the stores are
//   whole 32-byte sectors without it.
// What holds it now: the consumer warpgroup, one a block (two an SM): the
// A fragments' loads, the MMAs' latency and six float operations an output
// of the epilogue (bench/qstem_ab.py, PERF.md).
#include "hopper.cuh"

// One stem launch but its image and output, laid out once for each weight,
// shape, input type and alignment, relu and scale (kernels/qstem.py:
// StemLaunch, the same fields in the same order).
struct StemLaunch {
  const void* w;   // (N, ldw) int8: the prepared weight's rows, (dy, dx, c), dy chunks of 32
  const void* es;  // (N,) f32
  const void* eb;  // (N,) f32
  float scale;     // the f32 input's quantization scale
  float rcp;       // f32(1 / scale)
  int fast;        // 1: the certified quantize (rcp a normal float), 0: the division alone
  int h, w_, c, oh, ow, kh, kw, pad_top, pad_left, n, ldw, relu, f32;
  int cvec;        // staging copy width in bytes: 16, 4, or 0 (int8 rows read in the conversion)
  int rs;          // output rows a step
  int depth;       // steps of copies in flight (1 or 2)
  int ns;          // staging slots, one input row each
  int srow;        // bytes of a staging slot
  int nr;          // ring slots, one input row each (4 rs + 2 kh - 2: two steps' rows)
  int half;        // bytes of one copy of a ring row; a slot holds two
  int run_rows;    // output rows a run
  int runs_per_image, runs;
  int nchunks, nw; // output channels in chunks of nw (32 or 64: the wgmma's N)
  int b0;          // ring byte of padded column 0: even, 4-aligned image bytes where it can
  int stage_bytes, ring_bytes, b_bytes, smem, grid;
};

namespace {

constexpr int kStep = 32;     // reduction indices of one dy chunk: one k-step
constexpr int kThreads = 256;  // two warpgroups: the producer and the consumer
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23: adding it rounds |v| < 2^22 to an integer

struct qstem;  // kernel tag, named after the wrapper

// clip(rint(v / scale), +-127) as the low byte of the result, by the IEEE
// division; out of line, as the compiler would otherwise run the
// division's instructions, predicated off, on every element
__device__ __noinline__ uint32_t quantize_exact(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(q, kRound));
}

// The same, fast: t = v * rcp, clamped to +-127 (clipping before the
// rounding gives the same integer: the bounds are integers) and rounded
// half to even by adding 1.5 * 2^23. |t - v / scale| <= |t| * 2^-22 <
// 2^-14 where |t| < 128.5 (rcp = f32(1 / scale), one rounding each), and
// beyond 127.5 either quotient clips to 127: so t and the IEEE quotient
// round to the same integer unless t lies within 2^-14 of a half-integer.
// Returns false there (the division decides).
__device__ __forceinline__ bool quantize_fast(float v, float rcp, uint32_t& out) {
  const float t = fminf(fmaxf(__fmul_rn(v, rcp), -127.0f), 127.0f);
  const float r = __fadd_rn(t, kRound);
  out = __float_as_uint(r);
  return fabsf(__fsub_rn(t, __fsub_rn(r, kRound))) < 0.5f - 0.00006103515625f;
}

// four elements: the fast path for all four without a branch, and the
// division (element by element) only where one of them needs it
__device__ __forceinline__ void quantize4(const float (&f)[4], float scale, float rcp, bool fast,
                                          uint32_t (&v)[4]) {
  bool ok = fast;
#pragma unroll
  for (int i = 0; i < 4; ++i) ok &= quantize_fast(f[i], rcp, v[i]);
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!fast || !quantize_fast(f[i], rcp, v[i])) v[i] = quantize_exact(f[i], scale);
  }
}

// ---- mbarriers and bulk copies (the producer's 16-byte-aligned rows) ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tf2::smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tf2::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tf2::smem_u32(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(tf2::smem_u32(dst)), "l"(src), "r"(bytes), "r"(tf2::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B's column v of a chunk of NW channels holds output channel perm(v): the
// accumulator of column 8 j + 2 t + c (wgmma's D layout) is then channel
// (NW / 4) t + 2 j + c, a lane's NW / 4 consecutive channels.
template <int NW>
__device__ __forceinline__ int perm(int v) {
  return (NW / 4) * ((v & 7) >> 1) + 2 * (v >> 3) + (v & 1);
}

// requant's function (qgemm.cuh) on an accumulator that started at
// the bits of 1.5 * 2^23: the float 1.5 * 2^23 + acc less 1.5 * 2^23 is
// f32(acc) exactly (|acc| < 2^22), then * es and + eb (two roundings), relu
// or the low clip (lo is an integer, so clipping first rounds alike), the
// high clip, and the rounding by adding 1.5 * 2^23, whose low byte is the
// int8 result.
__device__ __forceinline__ uint32_t requant_magic(int bits, float es, float eb, float lo) {
  const float f = __fsub_rn(__int_as_float(bits), kRound);
  const float v = fminf(fmaxf(__fadd_rn(__fmul_rn(f, es), eb), lo), 127.0f);
  return __float_as_uint(__fadd_rn(v, kRound));
}

// Four requantized accumulators as four bytes of a word, in order.
__device__ __forceinline__ uint32_t pack4(const int* a, const float* es, const float* eb,
                                          float lo) {
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = requant_magic(a[i], es[i], eb[i], lo);
  return __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
}

// named barriers (0 is __syncthreads): FULL (a step's rows are in the
// ring) and EMPTY (the consumer has read them), by the step's parity; the
// producer's own
enum { kFull = 1, kEmpty = 3, kProducer = 5 };

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A block's walk: its runs (of run_rows output rows of one image) and in
// each the steps of rs rows, the same for both warpgroups.
struct Run {
  int img, oy0, rows, iy0, nstream, nsteps;
  __device__ Run(const StemLaunch& p, int run, int kh) {
    img = run / p.runs_per_image;
    oy0 = (run - img * p.runs_per_image) * p.run_rows;
    rows = min(p.run_rows, p.oh - oy0);
    iy0 = 2 * oy0 - p.pad_top;  // stream row j is input row iy0 + j
    nstream = 2 * (rows - 1) + kh;
    nsteps = (rows + p.rs - 1) / p.rs;
  }
};

template <typename Tag, bool F32, int KH, int NW>
__global__ void __launch_bounds__(kThreads, 2)
    qstem_kernel(const StemLaunch p, const void* __restrict__ x, int8_t* __restrict__ y) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int KT = (KH + 1) / 2;  // 64-byte K-tiles of B: two dy each
  constexpr int WG = 128;           // threads a warpgroup
  constexpr int LN = NW / 4;        // output channels a lane holds of a chunk
  uint8_t* stage = smem;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + p.stage_bytes);
  int8_t* sb = ring + p.ring_bytes;  // B: [chunk][K-tile][NW rows][64], swizzled
  float* ses = reinterpret_cast<float*>(sb + p.b_bytes);  // es, eb: [nchunks * NW] each
  float* seb = ses + p.nchunks * NW;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(seb + p.nchunks * NW);  // [ns]: the bulk copies
  const int tid = threadIdx.x;
  const int C = p.c, slot = 2 * p.half;
  const int lead = KH > 2 ? KH - 2 : 0;  // input rows consecutive steps share

  // ---- B, es and eb, once a block; the ring's pads stay zero from here on ----
  const int8_t* wrows = static_cast<const int8_t*>(p.w);
  for (int i = tid; i < p.nchunks * KT * NW * 4; i += kThreads) {
    const int c16 = i & 3, row = (i >> 2) % NW, tile = (i >> 2) / NW;  // tile = chunk * KT + kt
    const int q = tile / KT, kt = tile - q * KT, dy = 2 * kt + (c16 >> 1);
    const int ch = q * NW + perm<NW>(row);
    int4 v = make_int4(0, 0, 0, 0);
    if (ch < p.n && dy < KH)
      v = __ldg(reinterpret_cast<const int4*>(wrows + static_cast<size_t>(ch) * p.ldw + kStep * dy +
                                              16 * (c16 & 1)));
    *reinterpret_cast<int4*>(sb + tile * NW * 64 + tf2::swz64(row, c16)) = v;
  }
  for (int i = tid; i < p.nchunks * NW; i += kThreads) {
    ses[i] = i < p.n ? static_cast<const float*>(p.es)[i] : 0.0f;
    seb[i] = i < p.n ? static_cast<const float*>(p.eb)[i] : 0.0f;
  }
  for (int i = tid * 16; i < p.ring_bytes; i += kThreads * 16)
    *reinterpret_cast<int4*>(ring + i) = make_int4(0, 0, 0, 0);
  const bool tma = p.cvec == 16;  // 16-byte rows come in as bulk copies, one a row
  if (tma && tid == 0) {
    for (int i = 0; i < p.ns; ++i) mbar_init(mbar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  tf2::fence_async_smem();  // B, written by the threads, is read by wgmma
  __syncthreads();

  if (tid < WG) {
    // ================= producer: copies and quantizes rows =================
    const int row_elems = p.w_ * C;
    const int row_bytes = row_elems * (F32 ? 4 : 1);
    const int quads = (row_elems + 3) >> 2;           // conversion items a row
    const int vecs = p.cvec ? row_bytes / p.cvec : 0;  // copies a row
    const bool fast = p.fast != 0;
    const int p0 = p.b0 + p.pad_left * C;  // ring byte of the image's first byte
    const bool words = (p0 & 3) == 0;      // the image's bytes go in as 4-byte words
    int gs = 0, jbase = 0;  // the block's steps so far; its stream rows so far (ring index)
    for (int run = blockIdx.x; run < p.runs; run += gridDim.x) {
      const Run rn(p, run, KH);
      const char* ximg =
          static_cast<const char*>(x) + static_cast<size_t>(rn.img) * p.h * row_bytes;
      auto first = [&](int s) { return s ? 2 * p.rs * s + lead : 0; };
      auto last = [&](int s) { return min(2 * p.rs * s + 2 * p.rs + KH - 3, rn.nstream - 1); };
      // stream rows [j0, j1] into their staging slots (the block's row jbase + j
      // in slot (jbase + j) % ns): a bulk copy a row, completing on the slot's
      // mbarrier, issued by one thread; else cp.async, the items (row, copy)
      // walked by a stride of WG with no division
      auto issue = [&](int j0, int j1) {
        if (!p.cvec || j0 > j1) return;
        if (tma) {
          if (tid == 0) {
            tf2::fence_async_smem();  // the slots' last reads came before
            for (int j = j0, st = (jbase + j0) % p.ns; j <= j1; ++j) {
              const int iy = rn.iy0 + j;
              if (iy >= 0 && iy < p.h) {
                mbar_arrive_tx(mbar + st, row_bytes);
                bulk_copy(stage + st * p.srow, ximg + static_cast<size_t>(iy) * row_bytes,
                          row_bytes, mbar + st);
              } else {
                mbar_arrive_tx(mbar + st, 0);  // a row of pads: the phase completes empty
              }
              st = st + 1 == p.ns ? 0 : st + 1;
            }
          }
          return;
        }
        int j = j0, v = tid, st = (jbase + j0) % p.ns;
        while (v >= vecs) v -= vecs, ++j, st = st + 1 == p.ns ? 0 : st + 1;
        while (j <= j1) {
          const int iy = rn.iy0 + j;
          const bool inside = iy >= 0 && iy < p.h;
          const char* src = ximg + static_cast<size_t>(iy) * row_bytes;
          uint8_t* dst = stage + st * p.srow;
          for (; v < vecs; v += WG)
            if (inside) tf2::cp_async(dst + v * p.cvec, src + v * p.cvec, p.cvec, true);
          while (v >= vecs) v -= vecs, ++j, st = st + 1 == p.ns ? 0 : st + 1;
        }
      };
      // quantize stream rows [j0, j1] into both copies of their ring rows,
      // four elements an item, walked as issue's
      auto convert = [&](int j0, int j1) {
        if (j0 > j1) return;
        int j = j0, q = tid, st = (jbase + j0) % p.ns, rs_ = (jbase + j0) % p.nr;
        int phase = ((jbase + j0) / p.ns) & 1;  // of the slot's mbarrier
        auto next = [&] {
          q -= quads, ++j;
          if (++st == p.ns) st = 0, phase ^= 1;
          rs_ = rs_ + 1 == p.nr ? 0 : rs_ + 1;
        };
        while (q >= quads) next();
        while (j <= j1) {
          const int iy = rn.iy0 + j;
          const bool inside = iy >= 0 && iy < p.h;
          int8_t* d0 = ring + rs_ * slot + p0;
          int8_t* d1 = d0 + p.half - 2;  // the copy shifted by 2 bytes
          const uint8_t* src = stage + st * p.srow;
          const int8_t* direct =
              reinterpret_cast<const int8_t*>(ximg) + static_cast<size_t>(iy) * row_bytes;
          if (tma && inside && q < quads) mbar_wait(mbar + st, phase);
          for (; q < quads; q += WG) {
            const int e = 4 * q;
            uint32_t v[4] = {0u, 0u, 0u, 0u};
            if (inside) {
              if (F32) {
                float f[4];
                if (e + 4 <= row_elems) {
                  const float4 f4 = *reinterpret_cast<const float4*>(src + 4 * e);
                  f[0] = f4.x, f[1] = f4.y, f[2] = f4.z, f[3] = f4.w;
                } else {
#pragma unroll
                  for (int i = 0; i < 4; ++i)
                    f[i] = e + i < row_elems ? reinterpret_cast<const float*>(src)[e + i] : 0.0f;
                }
                quantize4(f, p.scale, p.rcp, fast, v);
              } else {
                const int8_t* b = p.cvec ? reinterpret_cast<const int8_t*>(src) : direct;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  v[i] = e + i < row_elems ? static_cast<uint8_t>(b[e + i]) : 0u;
              }
            }
            if (words && e + 4 <= row_elems) {
              const uint32_t w = __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                                             __byte_perm(v[2], v[3], 0x0040), 0x5410);
              *reinterpret_cast<uint32_t*>(d0 + e) = w;
              *reinterpret_cast<uint16_t*>(d1 + e) = static_cast<uint16_t>(w);
              *reinterpret_cast<uint16_t*>(d1 + e + 2) = static_cast<uint16_t>(w >> 16);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (e + i < row_elems)
                  d0[e + i] = static_cast<int8_t>(v[i]), d1[e + i] = static_cast<int8_t>(v[i]);
              }
            }
          }
          while (q >= quads) next();
        }
      };

      issue(0, KH - 3);
      tf2::cp_commit();
      for (int d = 0; d < p.depth; ++d) {
        issue(d ? first(d) : lead, last(d));
        tf2::cp_commit();
      }
      for (int s = 0; s < rn.nsteps; ++s, ++gs) {
        if (!tma) {  // (bulk-copied rows are waited for row by row in convert)
          if (p.depth == 2)
            tf2::cp_wait<1>();
          else
            tf2::cp_wait<0>();
          bar_sync(kProducer, WG);  // the step's rows landed, from every producer thread
        }
        if (gs >= 2) bar_sync(kEmpty + (gs & 1), kThreads);  // the consumer is past step gs - 2
        convert(first(s), last(s));
        bar_sync(kProducer, WG);  // the staging slots are free again
        issue(first(s + p.depth), last(s + p.depth));
        tf2::cp_commit();
        bar_arrive(kFull + (gs & 1), kThreads);
      }
      jbase += rn.nstream;
      tf2::cp_wait<0>();  // only empty groups remain; the next run reuses the slots
    }
    for (int g = max(gs - 2, 0); g < gs; ++g) bar_sync(kEmpty + (g & 1), kThreads);
    return;
  }

  // ================= consumer: MMAs and the epilogue =================
  const int ct = tid - WG, lane = ct & 31, wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const float lo = p.relu ? 0.0f : -127.0f;
  const bool full = (p.n & (LN - 1)) == 0;  // a lane's LN channels go out as one word
  int gs = 0, jbase = 0;
  for (int run = blockIdx.x; run < p.runs; run += gridDim.x) {
    const Run rn(p, run, KH);
    for (int s = 0; s < rn.nsteps; ++s, ++gs) {
      bar_sync(kFull + (gs & 1), kThreads);
      const int pixels = min(p.rs, rn.rows - p.rs * s) * p.ow;
      const int tiles = (pixels + 63) >> 6;
      const size_t px0 = (static_cast<size_t>(rn.img) * p.oh + rn.oy0 + p.rs * s) * p.ow;
      // this lane's two pixels of a tile (g and g + 8 of its warp's 16): the
      // step pixel m, its output row r and column ox, the ring slot of its
      // row dy = 0, advanced by 64 pixels a tile
      int m[2], ox[2], sl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = 16 * wr + g + 8 * h;
        const int r = m[h] / p.ow;
        ox[h] = m[h] - r * p.ow;
        sl[h] = (jbase + 2 * (p.rs * s + r)) % p.nr;
      }
      // a pixel past the step reads the step's last pixel (and is not stored)
      const int o_last = p.b0 + 2 * (p.ow - 1) * C + 4 * t;
      const int off_last = (o_last & 2) ? p.half + o_last - 2 : o_last;
      const int sl_last = (jbase + 2 * (p.rs * s + (pixels - 1) / p.ow)) % p.nr;
      for (int tile = 0; tile < tiles; ++tile) {
        uint32_t a[KH][4];
        {
          int off[2], sd[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = p.b0 + 2 * ox[h] * C + 4 * t;
            off[h] = m[h] < pixels ? ((o & 2) ? p.half + o - 2 : o) : off_last;
            sd[h] = m[h] < pixels ? sl[h] : sl_last;
          }
#pragma unroll
          for (int dy = 0; dy < KH; ++dy) {
            const int8_t* ra = ring + sd[0] * slot + off[0];
            const int8_t* rb = ring + sd[1] * slot + off[1];
            a[dy][0] = lds32(ra), a[dy][1] = lds32(rb), a[dy][2] = lds32(ra + 16),
            a[dy][3] = lds32(rb + 16);
#pragma unroll
            for (int h = 0; h < 2; ++h) sd[h] = sd[h] + 1 == p.nr ? 0 : sd[h] + 1;
          }
        }
        if (tile == tiles - 1) bar_arrive(kEmpty + (gs & 1), kThreads);  // the ring is read
        for (int q = 0; q < p.nchunks; ++q) {
          // the chunk's columns in two halves of NW / 2 (channels LN t + 0..LN/2 - 1
          // and the rest), each its own wgmma group: the first half's epilogue
          // runs while the second half's MMAs do
          constexpr int H = NW == 64 ? 2 : 1;
          // the accumulators start at the bits of 1.5 * 2^23: each ends as the
          // float 1.5 * 2^23 + sum (|sum| < 2^22), converted by one subtraction
          int acc[NW / 2];
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[i] = 0x4B400000;
          const uint64_t db = tf2::sw64_desc(sb + q * KT * NW * 64);
          tf2::wgmma_fence();
#pragma unroll
          for (int hf = 0; hf < H; ++hf) {
#pragma unroll
            for (int dy = 0; dy < KH; ++dy)
              tf2::wgmma_rs<NW / H>(acc + hf * (NW / 2 / H), a[dy],
                                db + hf * (NW / H * 64 >> 4) + (dy >> 1) * (NW * 64 >> 4) +
                                    2 * (dy & 1));
            tf2::wgmma_commit();
          }
          // ---- epilogue: a lane's LN consecutive channels, for its two pixels ----
          const int n0 = q * NW + LN * t;
          uint32_t w[2][LN / 4];
#pragma unroll
          for (int k = 0; k < LN / 4; ++k) {
            if (k == 0) {
              if constexpr (H == 2)
                tf2::wgmma_wait<1>();
              else
                tf2::wgmma_wait<0>();
            }
            if (H == 2 && k == LN / 8) tf2::wgmma_wait<0>();
            // channels n0 + 4 k .. + 3: accumulators 8 k + 2 h + (0, 1, 4, 5) of pixel h
            float es[4], eb[4];
            *reinterpret_cast<float4*>(es) = *reinterpret_cast<const float4*>(ses + n0 + 4 * k);
            *reinterpret_cast<float4*>(eb) = *reinterpret_cast<const float4*>(seb + n0 + 4 * k);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int v[4] = {acc[8 * k + 2 * h], acc[8 * k + 2 * h + 1], acc[8 * k + 4 + 2 * h],
                                acc[8 * k + 5 + 2 * h]};
              w[h][k] = pack4(v, es, eb, lo);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (m[h] < pixels && n0 < p.n) {
              int8_t* dst = y + (px0 + m[h]) * p.n + n0;
              if (full) {
                if constexpr (LN == 16)
                  *reinterpret_cast<uint4*>(dst) = make_uint4(w[h][0], w[h][1], w[h][2], w[h][3]);
                else
                  *reinterpret_cast<uint2*>(dst) = make_uint2(w[h][0], w[h][1]);
              } else {
#pragma unroll
                for (int b = 0; b < LN; ++b)
                  if (n0 + b < p.n)
                    dst[b] = static_cast<int8_t>((w[h][b >> 2] >> (8 * (b & 3))) & 0xFFu);
              }
            }
          }
        }
        // the next tile's pixels: 64 on
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m[h] += 64;
          ox[h] += 64;
          while (ox[h] >= p.ow) {
            ox[h] -= p.ow;
            sl[h] = sl[h] + 2 >= p.nr ? sl[h] + 2 - p.nr : sl[h] + 2;
          }
        }
      }
    }
    jbase += rn.nstream;
  }
}

template <bool F32, int KH, int NW>
int launch(const StemLaunch& l, const void* x, void* y, cudaStream_t stream) {
  static int granted = 48 * 1024;  // dynamic shared memory this kernel may use
  auto kernel = qstem_kernel<qstem, F32, KH, NW>;
  if (l.smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = l.smem;
  }
  kernel<<<l.grid, kThreads, l.smem, stream>>>(l, x, static_cast<int8_t*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <bool F32, int NW>
int launch_kh(const StemLaunch& l, const void* x, void* y, cudaStream_t stream) {
  switch (l.kh) {
    case 1: return launch<F32, 1, NW>(l, x, y, stream);
    case 3: return launch<F32, 3, NW>(l, x, y, stream);
    case 5: return launch<F32, 5, NW>(l, x, y, stream);
    case 7: return launch<F32, 7, NW>(l, x, y, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool F32>
int launch_f(const StemLaunch& l, const void* x, void* y, cudaStream_t stream) {
  return l.nw == 32 ? launch_kh<F32, 32>(l, x, y, stream) : launch_kh<F32, 64>(l, x, y, stream);
}

}  // namespace

// The dynamic shared memory a block may opt in to on the current device, or
// 0 (the wrapper raises on a plan that needs more).
extern "C" int tf2_qstem_max_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}

// x (B, H, W, C) f32 when l->f32 (quantized by l->scale), else int8; y (B,
// OH, OW, N) int8, 16-byte aligned. Returns cudaGetLastError().
extern "C" int tf2_qstem(const void* x, void* y, const StemLaunch* l, void* stream) {
  if (l->runs <= 0) return 0;
  if (l->kh != l->kw || l->kw * l->c > kStep || l->c < 1 || l->n < 1 ||
      (l->nw != 32 && l->nw != 64) || l->nchunks * l->nw < l->n || l->grid < 1 || l->rs < 1 ||
      l->depth < 1 || l->depth > 2 || l->nr != 4 * l->rs + 2 * l->kh - 2 ||
      l->ldw < l->kh * kStep)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l->f32 ? launch_f<true>(*l, x, y, s) : launch_f<false>(*l, x, y, s);
}
