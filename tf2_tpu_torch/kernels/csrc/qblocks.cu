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
// What bounds it on the card: int8 tensor-core operations at batch 64 (a
// block does Cin*Cm + 9*Cm*Cm + Cm*Cout (+ Cin*Cout) multiply-adds per
// pixel for Cin + Cout bytes of activations); but the weights (up to 4.4 MB
// a block at stage 4) must reach every CTA that multiplies with them, so
// the weight bytes a CTA streams from L2, and at batch 1 the few CTAs that
// stream them, set the time unless the work is cut so that each CTA streams
// little.
//
// What the design does about it. The TPU kernel kept a whole image of the
// chain in VMEM. Here a thread-block cluster of C CTAs (C = 1 a "band")
// owns a piece of the batch: G whole images, or one image's band of R rows
// and WC columns (kernels/qblocks.py: plan picks G, R, WC, C and the MMA
// width BN per block shape and batch). Each CTA of the cluster computes
// 1/C of the output channels of c1, of the 3x3 and of c3 (and the
// downsample), so it streams only 1/C of each weight:
//   1. c1 on the piece plus a one-pixel halo (none past the image's edges:
//      those are the 3x3's zero pads, so whole images recompute nothing)
//      into sH, int8, written into the shared memory of every CTA of the
//      cluster (distributed shared memory) in 16-byte chunks;
//   2. after a cluster barrier, the 3x3 from sH into sG the same way, each
//      lane's ldmatrix row pointing at its pixel's tap in sH (the padding
//      taps at a zero row): no im2col copy;
//   3. after a cluster barrier, the downsample (x streamed) and c3 from sG,
//      the add with the residual (x, copied with the last c3 step), out to
//      y in 16-byte chunks.
// h and g never leave the cluster; x is read for c1 (plus the halo of a
// band) and once for the residual; y is written once. Every phase runs one
// continuous pipeline over its (M tile, N tile, K step) steps: a 4-slot
// ring of 64-deep K steps filled by cp.async (the weight's K-major rows,
// prepared once at load, kernels/qblocks.py: prepare_w2 and
// shift_matmul.prepare_weight: 16-byte copies, no transpose), 3 steps
// ahead of the MMAs, across tile boundaries. The MMAs are int8 wgmma
// m64nBNk32 on 128-pixel tiles (two warpgroups of 64 rows), A from the ring
// (c1, downsample: ss) or from registers loaded by ldmatrix from sH / sG
// (the 3x3, c3: rs). Pixel rows in sH and sG are round_up(Cm, 16) plus 16
// or 32 bytes (an odd number of 16-byte chunks: conflict-free ldmatrix).
// Not done yet: weights kept as pot4 codes, TMA multicast of a weight tile
// to the cluster, one launch for the whole chain.
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "qgemm.cuh"

namespace {

struct qblockchain;  // kernel tag, named after the wrapper

namespace cg = cooperative_groups;

constexpr int TM = 128;             // pixels of an MMA tile: two warpgroups of 64
constexpr int BK = 64;              // reduction indices per K step
constexpr int STAGES = 4;           // ring slots
constexpr int LOOK = STAGES - 1;    // steps of copies in flight ahead
constexpr int NT = 256;

struct Params {
  const int8_t* x;                  // (B, H, W) pixels of xs bytes, channels [0, Cin)
  const int8_t *w1, *w2, *w3, *wd;  // K-major rows: (Cm, l1), (Cm, l2), (Cout, l3), (Cout, ld)
  int l1, l2, l3, ld;
  const float *es1, *eb1, *es2, *eb2, *es3, *eb3, *esd, *ebd;
  int8_t* y;                        // (B, H, W) pixels of ys bytes, channels [0, Cout)
  int xs, ys;
  int B, H, W, Cin, Cm, Cout;
  int CmP, PS;                      // Cm rounded up to 16; sH / sG pixel row bytes
  int G, R, WC, C;                  // the plan: images, band rows and columns, CTAs a cluster
  int tiles_y, tiles_x;             // bands a column and a row of the image
  int down, relu;
  float saso, sbso;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of a CTA (kernels/qblocks.py: smem_bytes): the ring, the
// output and residual tiles [TM][BN + 16], the 3x3's tap table and a zero
// row, sH (G x min(R + 2, H) x min(WC + 2, W) pixels), sG (G x R x WC
// pixels).
struct Layout {
  int so, sr, tab, zero, sh, sg, total;
  __host__ __device__ Layout(const Params& p, int bn) {
    so = STAGES * (TM + bn) * BK;
    sr = so + TM * (bn + 16);
    tab = sr + TM * (bn + 16);
    zero = tab + round16((9 * p.CmP + BK - 1) / BK * 16);
    sh = zero + 16;
    const int hr = p.R + 2 < p.H ? p.R + 2 : p.H, hc = p.WC + 2 < p.W ? p.WC + 2 : p.W;
    sg = sh + p.G * hr * hc * p.PS;
    total = sg + p.G * p.R * p.WC * p.PS;
  }
};

template <int NJ>
__device__ __forceinline__ void zero_acc(int (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;
}

// A step of a phase: K step ks of N tile nt of M tile mt (M tiles outer,
// then N tiles, then K), walked by counters: no division a step.
struct Step {
  int ks, nt, mt;
  __device__ __forceinline__ void next(int KS, int NTL) {
    if (++ks == KS) {
      ks = 0;
      if (++nt == NTL) {
        nt = 0;
        ++mt;
      }
    }
  }
};

// One phase: `total` steps of KS K steps and NTL N tiles to an M tile,
// through the ring. load(step, slot) issues a step's copies; mma(step,
// slot) its wgmmas; end(step, slot) runs after they retire (an epilogue at
// the last step of a tile). At step i the barrier publishes step i's
// copies (fenced to the async proxy) and guarantees that step i - 1's
// wgmmas and end are done, so step i + LOOK refills that slot.
template <int BN, class Load, class Mma, class End>
__device__ __forceinline__ void pipeline(int total, int KS, int NTL, int8_t* ring, Load load,
                                         Mma mma, End end) {
  constexpr int SLOT = (TM + BN) * BK;
  Step ps{0, 0, 0}, cs{0, 0, 0};  // the producer's and the consumer's step
  int pslot = 0, cslot = 0;
#pragma unroll
  for (int i = 0; i < LOOK; ++i) {
    if (i < total) {
      load(ps, ring + pslot * SLOT);
      ps.next(KS, NTL);
      pslot = pslot + 1 == STAGES ? 0 : pslot + 1;
    }
    tf2::cp_commit();
  }
  for (int i = 0; i < total; ++i) {
    tf2::cp_wait<LOOK - 1>();
    tf2::fence_async_smem();
    __syncthreads();
    if (i + LOOK < total) {
      load(ps, ring + pslot * SLOT);
      ps.next(KS, NTL);
      pslot = pslot + 1 == STAGES ? 0 : pslot + 1;
    }
    tf2::cp_commit();
    int8_t* slot = ring + cslot * SLOT;
    tf2::wgmma_fence();
    mma(cs, slot);
    tf2::wgmma_commit();
    tf2::wgmma_wait<0>();
    end(cs, slot);
    cs.next(KS, NTL);
    cslot = cslot + 1 == STAGES ? 0 : cslot + 1;
  }
  tf2::cp_wait<0>();
  __syncthreads();
}

template <class Tag, int BN>
__global__ void __launch_bounds__(NT, 2) qblock_kernel(const Params p) {
  constexpr int NJ = BN / 8, LDO = BN + 16, A_BYTES = TM * BK, CH = BN / 16;
  extern __shared__ __align__(1024) int8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(p, BN);
  int8_t* so = smem + L.so;
  int8_t* sr = smem + L.sr;
  int* tab = reinterpret_cast<int*>(smem + L.tab);
  const int8_t* zrow = smem + L.zero;
  int8_t* sH = smem + L.sh;
  int8_t* sG = smem + L.sg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * wq;  // this warp's 16 tile rows; acc rows row0 + g (+ 8)

  // ---- this CTA's piece: images, rows, columns, channel slices ----
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / p.C;
  const int bx = cl % p.tiles_x, by = (cl / p.tiles_x) % p.tiles_y;
  const int img0 = cl / (p.tiles_x * p.tiles_y) * p.G, nimg = min(p.G, p.B - img0);
  const int r0 = by * p.R, rows = min(p.R, p.H - r0);
  const int q0 = bx * p.WC, cols = min(p.WC, p.W - q0);
  const int ylo = max(r0 - 1, 0), c1rows = min(r0 + rows + 1, p.H) - ylo;
  const int xlo = max(q0 - 1, 0), c1cols = min(q0 + cols + 1, p.W) - xlo;
  const int M1 = nimg * c1rows * c1cols, M = nimg * rows * cols;
  const int cms = (p.Cm + p.C - 1) / p.C, cos_ = (p.Cout + p.C - 1) / p.C;
  const int m_lo = min(rank * cms, p.Cm), m_hi = min(m_lo + cms, p.Cm);
  const int o_lo = min(rank * cos_, p.Cout), o_hi = min(o_lo + cos_, p.Cout);
  const int nt1 = (m_hi - m_lo + BN - 1) / BN, nt3 = (o_hi - o_lo + BN - 1) / BN;
  const int mt1 = (M1 + TM - 1) / TM, mt = (M + TM - 1) / TM;
  const int ks1 = (p.Cin + BK - 1) / BK, ks2 = (9 * p.CmP + BK - 1) / BK;
  const int ks3 = (p.CmP + BK - 1) / BK, ksd = p.down ? ks1 : 0;

  // global pixel index of c1 pixel q (image-major, then rows, then columns
  // of the piece with its halo), and of output pixel q
  auto c1_pix = [&](int q) -> long long {
    const int per = c1rows * c1cols, s = q / per, rr = q - s * per, yy = rr / c1cols;
    return ((long long)(img0 + s) * p.H + ylo + yy) * p.W + xlo + rr - yy * c1cols;
  };
  auto out_pix = [&](int q) -> long long {
    const int per = rows * cols, s = q / per, rr = q - s * per, yy = rr / cols;
    return ((long long)(img0 + s) * p.H + r0 + yy) * p.W + q0 + rr - yy * cols;
  };

  // the 3x3's K: 16-byte granule e of step s is tap (dy, dx), channel c
  for (int i = tid; i < ks2 * 4; i += NT) {
    const int kk = 16 * i;
    int e = -1;
    if (kk < 9 * p.CmP) {
      const int tap = kk / p.CmP, c = kk - tap * p.CmP;
      e = ((tap / 3) << 24) | ((tap % 3) << 16) | c;
    }
    tab[i] = e;
  }
  if (tid < 4) reinterpret_cast<int*>(smem + L.zero)[tid] = 0;
  if (p.Cm % 16) {  // channels [Cm, CmP) of h and g meet the 3x3's and c3's K
    for (int i = tid; i < (L.total - L.sh) / 16; i += NT)
      reinterpret_cast<int4*>(sH)[i] = make_int4(0, 0, 0, 0);
  }
  cluster.sync();  // every CTA of the cluster runs before any remote write

  int acc[NJ][4];
  zero_acc(acc);
  const bool relu = p.relu != 0;

  // The streamed rows of this thread: rows tid / 4 and tid / 4 + 64 of the
  // M tile, 16-byte chunk tid % 4; their pixels' byte offsets in x, worked
  // out once an M tile (-1 past the tile's pixels).
  long long a_off[2];
  int a_mt = -1;
  auto a_rows = [&](int mt_, int mcount, auto&& pix) {
    if (mt_ == a_mt) return;
    a_mt = mt_;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = mt_ * TM + (tid >> 2) + 64 * h;
      a_off[h] = q < mcount ? pix(q) * p.xs : -1;
    }
  };
  auto load_rows = [&](int8_t* sa, int k0, int kmax) {
    const int k = k0 + 16 * (tid & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = a_off[h] >= 0 && k < kmax;
      tf2::cp_async(sa + tf2::swz64((tid >> 2) + 64 * h, tid & 3), in ? p.x + a_off[h] + k : p.x,
                    16, in);
    }
  };
  // B operand: weight rows n0 .. n0 + BN (those below nmax), chunk k0;
  // thread tid copies row tid / 4, chunk tid % 4
  auto load_w = [&](int8_t* sb, const int8_t* w, int lw, int n0, int nmax, int k0, int kmax) {
    if (tid < BN * 4) {
      const int row = tid >> 2, k = k0 + 16 * (tid & 3);
      const bool in = n0 + row < nmax && k < kmax;
      tf2::cp_async(sb + tf2::swz64(row, tid & 3), in ? w + (size_t)(n0 + row) * lw + k : w, 16,
                    in);
    }
  };
  // the requantized tile `so` (rows of the M tile at m0, channels n0 .. n0 +
  // BN below nmax) to dst(row) + channel, for rows below mcount: 16-byte
  // chunks, bytes at a ragged channel end
  auto store_tile = [&](int m0, int mcount, int n0, int nmax, auto&& dst) {
    for (int idx = tid; idx < TM * CH; idx += NT) {
      const int row = idx / CH, n = n0 + 16 * (idx - row * CH);
      if (m0 + row >= mcount || n >= nmax) continue;
      const int8_t* src = so + row * LDO + n - n0;
      dst(m0 + row, [&](int8_t* out) {
        if (n + 16 <= nmax)
          *reinterpret_cast<int4*>(out + n) = *reinterpret_cast<const int4*>(src);
        else
          for (int e = 0; n + e < nmax; ++e) out[n + e] = src[e];
      });
    }
  };
  // requant of the accumulators into so (channels past nmax: 0)
  auto requant_so = [&](int n0, int nmax, const float* es, const float* eb, bool rl) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + col + c;
          v[c] = n < nmax ? static_cast<uint8_t>(tf2::requant(acc[j][2 * h + c], es[n], eb[n], rl))
                          : 0u;
        }
        *reinterpret_cast<uint16_t*>(so + (row0 + g + 8 * h) * LDO + col) =
            static_cast<uint16_t>(v[0] | (v[1] << 8));
      }
    }
  };
  // an ldmatrix A fragment (this warp's 16 rows, 32 K bytes) from per-lane
  // row pointers, then the two k32 wgmmas of a step
  auto mma_rs = [&](const int8_t* a0, const int8_t* a1, const int8_t* sb) {
    uint32_t af[2][4];
    tf2::ldsm_x4(af[0], a0);
    tf2::ldsm_x4(af[1], a1);
    const uint64_t db = tf2::sw64_desc(sb);
    tf2::wgmma_rs<BN>(&acc[0][0], af[0], db);
    tf2::wgmma_rs<BN>(&acc[0][0], af[1], db + 2);
  };
  auto mma_ss = [&](const int8_t* slot) {
    const uint64_t da = tf2::sw64_desc(slot + 64 * wg * BK), db = tf2::sw64_desc(slot + A_BYTES);
    tf2::wgmma_ss<BN>(&acc[0][0], da, db);
    tf2::wgmma_ss<BN>(&acc[0][0], da + 2, db + 2);
  };
  // broadcast of a requantized tile into buffer `buf` (sH or sG) of every
  // CTA of the cluster, pixel rows of PS bytes
  auto broadcast = [&](int8_t* buf, int m0, int mcount, int n0, int nmax) {
    __syncthreads();
    for (int r = 0; r < p.C; ++r) {
      int8_t* dst = cluster.map_shared_rank(buf, r);
      store_tile(m0, mcount, n0, nmax, [&](int q, auto&& put) { put(dst + (size_t)q * p.PS); });
    }
  };

  // ---- 1. c1: h = relu-requant(x . w1) on the piece and its halo ----
  pipeline<BN>(
      mt1 * nt1 * ks1, ks1, nt1, smem,
      [&](const Step& s, int8_t* slot) {
        a_rows(s.mt, M1, c1_pix);
        load_rows(slot, s.ks * BK, p.Cin);
        load_w(slot + A_BYTES, p.w1, p.l1, m_lo + s.nt * BN, m_hi, s.ks * BK, p.Cin);
      },
      [&](const Step&, int8_t* slot) { mma_ss(slot); },
      [&](const Step& s, int8_t*) {
        if (s.ks != ks1 - 1) return;
        const int n0 = m_lo + s.nt * BN;
        requant_so(n0, m_hi, p.es1, p.eb1, true);
        broadcast(sH, s.mt * TM, M1, n0, m_hi);
        zero_acc(acc);
      });
  cluster.sync();

  // this lane's ldmatrix row: output pixel q of M tile m -> its center pixel
  // in sH, oy, ox (oy far negative past M); worked out once an M tile
  int l_mt = -1, l_ci = 0, l_oy = 0, l_ox = 0;
  auto lane_pixel = [&](int m) {
    if (m == l_mt) return;
    l_mt = m;
    const int q = m * TM + row0 + (lane & 15);
    if (q >= M) {
      l_oy = -(1 << 20);
      l_ci = l_ox = 0;
      return;
    }
    const int per = rows * cols, s = q / per, rr = q - s * per, yy = rr / cols;
    l_oy = r0 + yy;
    l_ox = q0 + rr - yy * cols;
    l_ci = s * c1rows * c1cols + (l_oy - ylo) * c1cols + l_ox - xlo;
  };

  // ---- 2. the 3x3: g = relu-requant(conv3x3(h, w2)) on the piece ----
  pipeline<BN>(
      mt * nt1 * ks2, ks2, nt1, smem,
      [&](const Step& s, int8_t* slot) {
        load_w(slot + A_BYTES, p.w2, p.l2, m_lo + s.nt * BN, m_hi, s.ks * BK, 9 * p.CmP);
      },
      [&](const Step& s, int8_t* slot) {
        lane_pixel(s.mt);
        const int8_t* a[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = tab[s.ks * 4 + 2 * h + (lane >> 4)];
          const int dy = (e >> 24) - 1, dx = ((e >> 16) & 0xFF) - 1;
          const bool in = e >= 0 && static_cast<unsigned>(l_oy + dy) < static_cast<unsigned>(p.H) &&
                          static_cast<unsigned>(l_ox + dx) < static_cast<unsigned>(p.W);
          a[h] = in ? sH + (size_t)(l_ci + dy * c1cols + dx) * p.PS + (e & 0xFFFF) : zrow;
        }
        mma_rs(a[0], a[1], slot + A_BYTES);
      },
      [&](const Step& s, int8_t*) {
        if (s.ks != ks2 - 1) return;
        const int n0 = m_lo + s.nt * BN;
        requant_so(n0, m_hi, p.es2, p.eb2, true);
        broadcast(sG, s.mt * TM, M, n0, m_hi);
        zero_acc(acc);
      });
  cluster.sync();

  // ---- 3. downsample, c3 and the add, out to y ----
  const int kt = ksd + ks3;  // K steps of an output tile
  a_mt = -1;
  pipeline<BN>(
      mt * nt3 * kt, kt, nt3, smem,
      [&](const Step& s, int8_t* slot) {
        const int n0 = o_lo + s.nt * BN;
        a_rows(s.mt, M, out_pix);
        if (s.ks < ksd) {
          load_rows(slot, s.ks * BK, p.Cin);
          load_w(slot + A_BYTES, p.wd, p.ld, n0, o_hi, s.ks * BK, p.Cin);
          return;
        }
        load_w(slot + A_BYTES, p.w3, p.l3, n0, o_hi, (s.ks - ksd) * BK, p.CmP);
        if (!p.down && s.ks == kt - 1 && 16 * (tid & 3) < BN) {
          // the identity residual x[pixel, n0 .. n0 + BN], into the slot's A
          // region [TM][BN], on this thread's streamed rows
          const int n = n0 + 16 * (tid & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool in = a_off[h] >= 0 && n < o_hi;
            tf2::cp_async(slot + ((tid >> 2) + 64 * h) * BN + 16 * (tid & 3),
                          in ? p.x + a_off[h] + n : p.x, 16, in);
          }
        }
      },
      [&](const Step& s, int8_t* slot) {
        if (s.ks < ksd) {
          mma_ss(slot);
          return;
        }
        const int q = s.mt * TM + row0 + (lane & 15), k = (s.ks - ksd) * BK + 16 * (lane >> 4);
        const int8_t* row = q < M ? sG + (size_t)q * p.PS : zrow;
        mma_rs(q < M && k < p.CmP ? row + k : zrow, q < M && k + 32 < p.CmP ? row + k + 32 : zrow,
               slot + A_BYTES);
      },
      [&](const Step& s, int8_t* slot) {
        const int n0 = o_lo + s.nt * BN, m0 = s.mt * TM;
        if (s.ks == ksd - 1) {  // the downsample's tile, requantized into sr
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1), n = n0 + col;
              sr[(row0 + g + 8 * (e >> 1)) * LDO + col] =
                  n < o_hi ? tf2::requant(acc[j][e], p.esd[n], p.ebd[n], false) : 0;
            }
          zero_acc(acc);
          return;
        }
        if (s.ks != kt - 1) return;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + g + 8 * h;
            uint32_t v[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = 8 * j + 2 * t + c, n = n0 + col;
              if (n >= o_hi) {
                v[c] = 0;
                continue;
              }
              const float y3 = tf2::requant(acc[j][2 * h + c], p.es3[n], p.eb3[n], false);
              const float r = p.down ? (float)sr[row * LDO + col] : (float)slot[row * BN + col];
              float f = __fadd_rn(__fmul_rn(y3, p.saso), __fmul_rn(r, p.sbso));
              if (relu) f = fmaxf(f, 0.0f);
              f = fminf(fmaxf(rintf(f), -127.0f), 127.0f);
              v[c] = static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(f)));
            }
            *reinterpret_cast<uint16_t*>(so + row * LDO + 8 * j + 2 * t) =
                static_cast<uint16_t>(v[0] | (v[1] << 8));
          }
        __syncthreads();
        store_tile(m0, M, n0, o_hi,
                   [&](int q, auto&& put) { put(p.y + out_pix(q) * p.ys); });
        zero_acc(acc);
      });
}

// Raises the kernel's dynamic shared memory limit to `smem` (once for each
// larger value) and allows clusters of more than 8 CTAs.
template <int BN>
cudaError_t grant(int smem) {
  static int granted = 48 * 1024;
  static bool wide = false;
  auto kernel = qblock_kernel<qblockchain, BN>;
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  if (!wide) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wide = true;
  }
  return cudaSuccess;
}

template <int BN>
int launch(const Params& p, void* stream) {
  const Layout L(p, BN);
  auto kernel = qblock_kernel<qblockchain, BN>;
  cudaError_t e = grant<BN>(L.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int clusters = (p.B + p.G - 1) / p.G * p.tiles_y * p.tiles_x;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * p.C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int max_clusters(const Params& p) {
  const Layout L(p, BN);
  auto kernel = qblock_kernel<qblockchain, BN>;
  if (grant<BN>(L.total) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L.total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

Params block_params(const void* x, int xs, const void* w1, int l1, const void* es1,
                    const void* eb1, const void* w2, int l2, const void* es2, const void* eb2,
                    const void* w3, int l3, const void* es3, const void* eb3, const void* wd,
                    int ld, const void* esd, const void* ebd, void* y, int ys, int b, int h,
                    int w, int cin, int cm, int cout, int down, int relu, float saso,
                    float sbso, int G, int R, int WC, int C) {
  Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.xs = xs;
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.w3 = static_cast<const int8_t*>(w3);
  p.wd = static_cast<const int8_t*>(wd);
  p.l1 = l1;
  p.l2 = l2;
  p.l3 = l3;
  p.ld = ld;
  p.es1 = static_cast<const float*>(es1);
  p.eb1 = static_cast<const float*>(eb1);
  p.es2 = static_cast<const float*>(es2);
  p.eb2 = static_cast<const float*>(eb2);
  p.es3 = static_cast<const float*>(es3);
  p.eb3 = static_cast<const float*>(eb3);
  p.esd = static_cast<const float*>(esd);
  p.ebd = static_cast<const float*>(ebd);
  p.y = static_cast<int8_t*>(y);
  p.ys = ys;
  p.B = b;
  p.H = h;
  p.W = w;
  p.Cin = cin;
  p.Cm = cm;
  p.Cout = cout;
  p.CmP = round16(cm);
  p.PS = p.CmP + (((p.CmP >> 4) & 1) ? 32 : 16);
  p.G = G;
  p.R = R;
  p.WC = WC;
  p.C = C;
  p.tiles_y = (h + R - 1) / R;
  p.tiles_x = (w + WC - 1) / WC;
  p.down = down;
  p.relu = relu;
  p.saso = saso;
  p.sbso = sbso;
  return p;
}

}  // namespace

// One bottleneck block. x: (B, H, W) pixels of xs bytes (xs % 16 == 0,
// 16-byte aligned), channels [0, Cin), zero in [Cin, round_up(Cin, 16));
// w1 (Cm, l1), w2 (Cm, l2) with K = 9 * round_up(Cm, 16) in (dy, dx, c)
// order, w3 (Cout, l3), wd (Cout, ld) (null unless down): K-major int8 rows,
// 16-byte aligned, l* % 16 == 0, readable to the K rounded up to 16; es*/eb*
// f32 per output channel; y: (B, H, W) pixels of ys bytes, channels [0,
// Cout) written, not overlapping x. G, R, WC, C, bn: the plan
// (kernels/qblocks.py: plan). Returns the CUDA error of the attribute calls
// or the launch.
extern "C" int tf2_qblock(const void* x, int xs, const void* w1, int l1, const void* es1,
                          const void* eb1, const void* w2, int l2, const void* es2,
                          const void* eb2, const void* w3, int l3, const void* es3,
                          const void* eb3, const void* wd, int ld, const void* esd,
                          const void* ebd, void* y, int ys, int b, int h, int w, int cin,
                          int cm, int cout, int down, int relu, float saso, float sbso, int G,
                          int R, int WC, int C, int bn, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const Params p = block_params(x, xs, w1, l1, es1, eb1, w2, l2, es2, eb2, w3, l3, es3, eb3, wd,
                                ld, esd, ebd, y, ys, b, h, w, cin, cm, cout, down, relu, saso,
                                sbso, G, R, WC, C);
  if (bn == 32) return launch<32>(p, stream);
  if (bn == 64) return launch<64>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of the plan's shape (C CTAs of the plan's shared
// memory) the card can hold at once; 0 if none, -1 on a CUDA error.
extern "C" int tf2_qblock_max_clusters(int h, int w, int cm, int G, int R, int WC, int C,
                                       int bn) {
  const Params p = block_params(nullptr, 16, nullptr, 16, nullptr, nullptr, nullptr, 16,
                                nullptr, nullptr, nullptr, 16, nullptr, nullptr, nullptr, 16,
                                nullptr, nullptr, nullptr, 16, G, h, w, 16, cm, 16, 0, 0, 0.f,
                                0.f, G, R, WC, C);
  if (bn == 32) return max_clusters<32>(p);
  if (bn == 64) return max_clusters<64>(p);
  return -1;
}
