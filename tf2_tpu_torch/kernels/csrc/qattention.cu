// Fused int8 attention core for Hopper: packed qkv (N, T, 3*dim) int8 in,
// (N, T, dim) int8 out, one head of width hd = dim / heads at a time, any
// T >= 1 and hd a multiple of 16 up to 128.
//
// Replaces tf2_tpu/kernels/qattention.py:
//   tf2_qattention  <- _qattn_kernel (:42, called through _qattn_call :90)
// On the ViT-B/16 path it runs the 12 attention cores of a forward (T = 196,
// 197 with the class token; 576 and 577 at 384x384; 12 heads of 64).
//
// What it computes (kernels/qattention.py has the plain version), per head:
//   acc    = Q K^T in int32, exact
//   logits = f32(acc) * qk_scale
//   e      = f32(exp(double(logits - rowmax)));  sum = f32(sum of e in double)
//   p_q    = rint((e / sum) * 127)                 int8 in [0, 127]
//   y      = clip(rint(f32(p_q V) * pv_scale), +-127)
// Every f32 step is one correctly rounded operation (__fsub_rn, __fmul_rn,
// __fdiv_rn; nothing contracts into an FMA), the exp is the double-precision
// exp torch.exp calls on the card, so the result equals the plain version's
// on the card; the double row sum, taken in another order than torch's,
// differs only when it sits within a few double ulps of an f32 rounding
// boundary. Every logit and exp is a function of its inputs alone, so
// computing one twice gives the same bits.
//
// What bounds it on the card: memory bytes, 3*dim + dim bytes a token (the
// int8 qkv read once, the output written once). The two products are
// 4*T*hd multiply-accumulates a token and head, small beside the int8
// tensor-core rate; the softmax takes T double exps and T divisions a token
// and head, and their latency, with the registers that hold the row's
// logits, is what the kernel spends its time on.
//
// What the design does about it: a warp owns a group of query rows and
// keeps their logits in the mma.sync m16n8k32 accumulator registers; the
// row max and the double row sum are shuffles within the 4 lanes of a row,
// and a lane's exps are independent of one another. p_q is packed from
// those registers straight into the A fragments of the P V product; the C
// fragment's column order differs from the A fragment's k order, so V^T is
// stored with its keys permuted to match (the int32 sum is the same in any
// order). The division takes a certified fast path (pq_fast below) and
// __fdiv_rn only where that is not proven exact. K reaches shared memory
// by 16-byte cp.async, V^T by 4x4 byte transposes in registers
// (__byte_perm); no logit or probability lives in shared memory. A block
// of 4 warps takes one (image, head) and a share of its query groups (all
// of them when N * heads fills the card, so K and V are copied once a
// head). Two shapes, chosen from T (measured on the H100 against other
// chunk sizes and rows a warp):
// - T <= 256 (ViT-B/16 at 224x224): one pass, 8 query rows a warp (rows
//   8-15 of each mma left empty), all of a row's logits in registers (64 a
//   lane, 232 registers a thread at hd 64): each exp and division once.
// - longer: three passes over chunks of 64 keys, 16 rows a warp (the max;
//   the exps and their sum; the exps again, p_q and P V), recomputing Q K^T
//   and the exps instead of keeping them. K and V^T stay in shared memory
//   when they fit kResidentBytes (T = 577 at hd 64), else each chunk is
//   streamed through it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// K and V^T of a whole head stay in shared memory up to this size, which
// leaves room for two blocks an SM
constexpr int kResidentBytes = 110 * 1024;

struct qattention;  // kernel tag, named after the wrapper

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A kernel's shape: head width HD; RH rows of the m16 tile a lane holds
// (a warp takes 8 * RH query rows; RH = 1 leaves rows 8-15 of each mma
// empty); CK keys whose logits a warp holds at a time.
template <int HD_, int RH_, int CK_>
struct Cfg {
  static constexpr int HD = HD_, RH = RH_, CK = CK_;
  static constexpr int NT = HD / 8;          // n-tiles of P V (output dims)
  static constexpr int KS = (HD + 31) / 32;  // k32 steps of Q K^T
  static constexpr int CT = CK / 8;          // n-tiles of a chunk of keys
  static constexpr int ROWS = 8 * RH;        // query rows a warp takes at a time
};
// T <= kOnePass keys: one pass, 8 rows a warp, the whole row's logits in
// registers. Longer: three passes over chunks of 64 keys, 16 rows a warp.
constexpr int kOnePass = 256;
template <int HD>
using OnePass = Cfg<HD, 1, kOnePass>;
template <int HD>
using ThreePass = Cfg<HD, 2, 64>;

// Shared memory of a block: K (span rows of ldk bytes), then V^T (hd rows
// of span + 16 bytes, keys permuted within each group of 32). span is the
// whole sequence when it fits kResidentBytes, else one chunk.
struct Layout {
  int ldk, ldv, span, vt_off, bytes;
  bool resident;
};

__host__ __device__ inline Layout layout(int t, int hd, int ck) {
  Layout L;
  L.ldk = round_up(hd, 32) + 16;
  const int t32 = round_up(t, 32);
  L.resident = t32 * L.ldk + hd * (t32 + 16) <= kResidentBytes;
  L.span = L.resident ? t32 : ck;
  L.ldv = L.span + 16;
  L.vt_off = L.span * L.ldk;
  L.bytes = L.vt_off + hd * L.ldv;
  return L;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Keys [k0, k0 + n) of the head into shared memory, then a barrier. K rows
// land as they are. V^T: column 32*kg + L of dim d holds V[key(L)][d],
// L = 16*hf + 4*tq + j -> key = 16*hf + 8*(j >> 1) + 2*tq + (j & 1): the
// order in which an m16n8k32 C fragment holds a row's logits of four
// n-tiles, so p_q packs from those registers into A fragments as it is.
// Keys past the sequence read as 0.
template <int HD>
__device__ void load_keys(const int8_t* kbase, const int8_t* vbase, size_t stride, int k0,
                          int n, int8_t* sK, int8_t* sVt, const Layout& L) {
  constexpr int CH = HD / 16;
  constexpr int DQ = HD / 4;
  for (int i = threadIdx.x; i < n * CH; i += kThreads) {
    const int r = i / CH, c = i - r * CH;
    cp_async16(sK + r * L.ldk + c * 16, kbase + static_cast<size_t>(k0 + r) * stride + c * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int quads = round_up(n, 32) / 4;
  for (int i = threadIdx.x; i < quads * DQ; i += kThreads) {
    const int u = i / DQ, dq = i - u * DQ;
    const int key = (u >> 3) * 32 + ((u >> 2) & 1) * 16 + (u & 3) * 2;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = key + (j & 1) + 8 * (j >> 1);
      w[j] = kk < n ? ld32(vbase + static_cast<size_t>(k0 + kk) * stride + dq * 4) : 0u;
    }
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
    int8_t* dst = sVt + dq * 4 * L.ldv + u * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + L.ldv) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * L.ldv) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * L.ldv) = __byte_perm(hi01, hi23, 0x7632);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// ---- the division, certified against the exact steps ----
//
// The exact step, as the plain version takes it: p_q = rint(RN32(RN32(e /
// total) * 127)). Its division carries a slow path behind a branch; each
// element first takes a branch-free fast path whose result is proven to
// equal the exact one, or is flagged, and flagged elements take the exact
// steps afterwards (on ViT-B/16's shapes about 1 element in 20,000,
// tf2_tpu_torch/bench/qattention_ab.py).
//
// pq_fast: with rcp = RN32(1 / total) (correctly rounded, once a row),
// y' = RN32(RN32(e rcp) 127). Since e <= total, e / total <= 1, and with
// each of the five roundings within 2^-24 relative, |y' - y| <= 127 * 5.01
// * 2^-24 < 2^-14.6, y = RN32(RN32(e / total) 127) (an e so small that
// e rcp is subnormal gives y, y' < 2^-118 and p_q = 0 either way). So
// rint(y') = rint(y) unless y' lies within 2^-13 of a half-integer, which
// is flagged.
__device__ __forceinline__ uint32_t pq_fast(float e, float rcp, bool& sure) {
  const float y = __fmul_rn(__fmul_rn(e, rcp), 127.0f);
  const float k = rintf(y);
  sure = fabsf(__fsub_rn(y, k)) < 0.5f - 0x1p-13f;
  return static_cast<uint32_t>(__float2int_rn(k));
}

__device__ __noinline__ uint32_t pq_exact(float e, float total) {
  return static_cast<uint32_t>(__float2int_rn(__fmul_rn(__fdiv_rn(e, total), 127.0f)));
}

// One warp's 8 * RH query rows of one head: the Q fragments, a chunk's
// logits (then their exps) in C-fragment order, the max and double sums of
// the RH rows a lane holds, and the P V accumulators. ``fallbacks`` (or
// null) counts the elements whose division took the exact steps.
template <class C>
struct Rows {
  static constexpr int HD = C::HD;
  uint32_t af[C::KS][4];
  float s[C::CT][2 * C::RH];
  float mx[C::RH];
  double sum[C::RH][2];
  float total[C::RH], rcp[C::RH];
  int acc[C::NT][4];
  int g, tq;

  // Q rows [q0, q0 + ROWS), 0 past the sequence and past hd
  __device__ __forceinline__ void init(const int8_t* qbase, size_t stride, int t, int q0,
                                       bool active) {
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    tq = lane & 3;
    const int r0 = q0 + g, r1 = r0 + 8;
    const bool v0 = active && r0 < t, v1 = C::RH == 2 && active && r1 < t;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      const int col = ks * 32 + tq * 4;
      const bool hi = col + 16 < HD;
      af[ks][0] = v0 ? ld32(qbase + r0 * stride + col) : 0u;
      af[ks][1] = v1 ? ld32(qbase + r1 * stride + col) : 0u;
      af[ks][2] = v0 && hi ? ld32(qbase + r0 * stride + col + 16) : 0u;
      af[ks][3] = v1 && hi ? ld32(qbase + r1 * stride + col + 16) : 0u;
    }
#pragma unroll
    for (int r = 0; r < C::RH; ++r) {
      mx[r] = __int_as_float(0xff800000);  // -inf
      sum[r][0] = sum[r][1] = 0.0;
    }
#pragma unroll
    for (int nd = 0; nd < C::NT; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0;
  }

  // the logits of a chunk of n keys (K rows at kc), -inf past its end
  __device__ __forceinline__ void logits(const int8_t* kc, int ldk, int n, float qk_scale) {
#pragma unroll
    for (int nt = 0; nt < C::CT; ++nt) {
      if (nt * 8 < n) {
        int d[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < C::KS; ++ks) {
          const int8_t* pb = kc + (nt * 8 + g) * ldk + ks * 32 + tq * 4;
          mma(d, af[ks], ld32(pb), ld32(pb + 16));
        }
        const int key = nt * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2 * C::RH; ++e)
          s[nt][e] = key + (e & 1) < n ? __fmul_rn(__int2float_rn(d[e]), qk_scale)
                                       : __int_as_float(0xff800000);
      }
    }
  }

  __device__ __forceinline__ void row_max(int n) {
#pragma unroll
    for (int nt = 0; nt < C::CT; ++nt)
      if (nt * 8 < n) {
#pragma unroll
        for (int r = 0; r < C::RH; ++r)
          mx[r] = fmaxf(mx[r], fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
  }

  // the max over the 4 lanes that hold a row
  __device__ __forceinline__ void quad_max() {
#pragma unroll
    for (int r = 0; r < C::RH; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
  }

  // s -> f32(exp(f64(s - max))), the double exp torch.exp takes on the
  // card, and with `add` into the lane's double row sums (two a row, by
  // column parity)
  __device__ __forceinline__ void exps(int n, bool add) {
#pragma unroll
    for (int nt = 0; nt < C::CT; ++nt)
      if (nt * 8 < n) {
#pragma unroll
        for (int e = 0; e < 2 * C::RH; ++e) {
          s[nt][e] = __double2float_rn(exp(static_cast<double>(__fsub_rn(s[nt][e], mx[e >> 1]))));
          if (add)
            sum[e >> 1][e & 1] = __dadd_rn(sum[e >> 1][e & 1], static_cast<double>(s[nt][e]));
        }
      }
  }

  // each row's sum over its 4 lanes, rounded once to f32, and its
  // correctly rounded reciprocal
  __device__ __forceinline__ void row_total() {
#pragma unroll
    for (int r = 0; r < C::RH; ++r) {
      double v = __dadd_rn(sum[r][0], sum[r][1]);
      v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      total[r] = __double2float_rn(v);
      rcp[r] = __frcp_rn(total[r]);
    }
  }

  // p_q packed from s into A fragments, times the chunk's V^T (at vc)
  __device__ __forceinline__ void pv(const int8_t* vc, int ldv, int n,
                                     unsigned long long* fallbacks) {
#pragma unroll
    for (int ks = 0; ks < C::CK / 32; ++ks) {
      if (ks * 32 < n) {
        uint32_t q[4][4];
        uint32_t flagged = 0;
        // q[i][e]: n-tile 4ks + i, C-fragment element e (e >= 2, rows 8-15,
        // stay 0 when RH = 1); c, r: e's index into s and its row
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nt = 4 * ks + i, c = e % (2 * C::RH), r = c >> 1;
            bool sure = true;
            q[i][e] = e < 2 * C::RH && nt * 8 < n ? pq_fast(s[nt][c], rcp[r], sure) : 0u;
            flagged |= static_cast<uint32_t>(!sure) << (i * 4 + e);
          }
        if (flagged) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = e % (2 * C::RH);
              if (flagged >> (i * 4 + e) & 1u) q[i][e] = pq_exact(s[4 * ks + i][c], total[c >> 1]);
            }
          if (fallbacks) atomicAdd(fallbacks, static_cast<unsigned long long>(__popc(flagged)));
        }
        // A fragment k order = the C fragment's column order of n-tiles
        // 4ks .. 4ks + 3 (V^T's keys are permuted to match)
        uint32_t a[4];
        a[0] = q[0][0] | q[0][1] << 8 | q[1][0] << 16 | q[1][1] << 24;
        a[1] = q[0][2] | q[0][3] << 8 | q[1][2] << 16 | q[1][3] << 24;
        a[2] = q[2][0] | q[2][1] << 8 | q[3][0] << 16 | q[3][1] << 24;
        a[3] = q[2][2] | q[2][3] << 8 | q[3][2] << 16 | q[3][3] << 24;
#pragma unroll
        for (int nd = 0; nd < C::NT; ++nd) {
          const int8_t* pb = vc + (nd * 8 + g) * ldv + ks * 32 + tq * 4;
          mma(acc[nd], a, ld32(pb), ld32(pb + 16));
        }
      }
    }
  }

  // the requant of rows [q0, q0 + ROWS) that lie in the sequence
  __device__ __forceinline__ void store(int8_t* ybase, int dim, int t, int q0,
                                        float pv_scale) const {
#pragma unroll
    for (int hh = 0; hh < C::RH; ++hh) {
      const int r = q0 + g + 8 * hh;
      if (r >= t) continue;
      int8_t* out = ybase + static_cast<size_t>(r) * dim;
#pragma unroll
      for (int nd = 0; nd < C::NT; ++nd) {
        uint32_t packed = 0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = rintf(__fmul_rn(__int2float_rn(acc[nd][2 * hh + c]), pv_scale));
          packed |= (static_cast<uint32_t>(__float2int_rn(fminf(fmaxf(v, -127.0f), 127.0f))) &
                     0xffu) << (8 * c);
        }
        *reinterpret_cast<uint16_t*>(out + nd * 8 + 2 * tq) = static_cast<uint16_t>(packed);
      }
    }
  }
};

// Chunk c of the head: its number of keys, and in kc, vc where its K and
// V^T lie in shared memory. STREAM: loads it there first, after a barrier
// that waits for every warp to be done with the previous chunk.
template <class C, bool STREAM>
__device__ __forceinline__ int stage_chunk(const int8_t* qbase, size_t stride, int dim, int t,
                                           int c, int8_t* sK, int8_t* sVt, const Layout& L,
                                           const int8_t*& kc, const int8_t*& vc) {
  const int k0 = c * C::CK;
  const int n = min(C::CK, t - k0);
  if (STREAM) {
    __syncthreads();
    load_keys<C::HD>(qbase + dim, qbase + 2 * dim, stride, k0, n, sK, sVt, L);
    kc = sK;
    vc = sVt;
  } else {
    kc = sK + k0 * L.ldk;
    vc = sVt + k0;
  }
  return n;
}

// One warp's query rows [q0, q0 + ROWS) of one head. STREAM: the keys are
// streamed through shared memory chunk by chunk (every warp of the block
// calls this in step, active or not, for the barriers); otherwise the
// whole head is in shared memory already. One chunk: the logits, max,
// exps, sum, p_q and P V in one pass. Several: pass 0 takes the max, pass
// 1 the sum, pass 2 p_q and P V, each recomputing the logits (and 1 and 2
// the exps) of every chunk.
template <class C, bool STREAM>
__device__ __forceinline__ void attend(const int8_t* qbase, size_t stride, int dim, int t,
                                       int q0, bool active, int8_t* sK, int8_t* sVt,
                                       const Layout& L, float qk_scale, float pv_scale,
                                       int8_t* ybase, unsigned long long* fallbacks) {
  Rows<C> w;
  w.init(qbase, stride, t, q0, active);
  const int chunks = (t + C::CK - 1) / C::CK;
  const bool single = chunks == 1;
  for (int pass = single ? 2 : 0; pass < 3; ++pass) {
    for (int c = 0; c < chunks; ++c) {
      const int8_t *kc, *vc;
      const int n = stage_chunk<C, STREAM>(qbase, stride, dim, t, c, sK, sVt, L, kc, vc);
      if (!active) continue;
      w.logits(kc, L.ldk, n, qk_scale);
      if (pass == 0 || single) w.row_max(n);
      if (pass == 0) continue;
      if (single) w.quad_max();
      w.exps(n, pass == 1 || single);
      if (pass == 1) continue;
      if (single) w.row_total();
      w.pv(vc, L.ldv, n, fallbacks);
    }
    if (pass == 0) w.quad_max();
    if (pass == 1) w.row_total();
  }
  if (active) w.store(ybase, dim, t, q0, pv_scale);
}

// grid (query slices, heads, N). Slice x takes the query groups (C::ROWS
// rows each) x, x + gridDim.x, ...; warp w of the block the w-th, (w + 4)-th,
// ... of them.
template <class Tag, class C, bool STREAM>
__global__ void __launch_bounds__(kThreads, 2)
qattn_kernel(const int8_t* __restrict__ qkv, int8_t* __restrict__ y, int t, int heads,
             float qk_scale, float pv_scale, unsigned long long* fallbacks) {
  extern __shared__ __align__(16) int8_t smem[];
  const Layout L = layout(t, C::HD, C::CK);
  int8_t* sK = smem;
  int8_t* sVt = smem + L.vt_off;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y, n = blockIdx.z;
  const int dim = heads * C::HD;
  const size_t stride = 3 * static_cast<size_t>(dim);
  const int8_t* qbase = qkv + static_cast<size_t>(n) * t * stride + h * C::HD;
  int8_t* ybase = y + static_cast<size_t>(n) * t * dim + h * C::HD;
  const int groups = (t + C::ROWS - 1) / C::ROWS;
  const int mine = (groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  auto q0 = [&](int j) { return (blockIdx.x + j * gridDim.x) * C::ROWS; };
  if (!STREAM) {
    load_keys<C::HD>(qbase + dim, qbase + 2 * dim, stride, 0, t, sK, sVt, L);
    for (int j = warp; j < mine; j += kWarps)
      attend<C, false>(qbase, stride, dim, t, q0(j), true, sK, sVt, L, qk_scale, pv_scale,
                       ybase, fallbacks);
  } else {
    for (int j0 = 0; j0 < mine; j0 += kWarps)
      attend<C, true>(qbase, stride, dim, t, q0(j0 + warp), j0 + warp < mine, sK, sVt, L,
                      qk_scale, pv_scale, ybase, fallbacks);
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <class C, bool STREAM>
int launch_kernel(const void* qkv, void* y, int n, int t, int heads, float qk_scale,
                  float pv_scale, const Layout& L, void* fallbacks, void* stream) {
  static int opted_in = 48 * 1024;  // dynamic shared memory this kernel may use
  auto kernel = qattn_kernel<qattention, C, STREAM>;
  if (L.bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = L.bytes;
  }
  // one slice a head when N * heads blocks fill the card four deep; else
  // more slices, up to one a block of 4 warps' worth of query groups
  const int groups = (t + C::ROWS - 1) / C::ROWS;
  const int want = (4 * sm_count() + n * heads - 1) / (n * heads);
  const int slices = max(1, min(want, (groups + kWarps - 1) / kWarps));
  const dim3 grid(slices, heads, n);
  kernel<<<grid, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<int8_t*>(y), t, heads, qk_scale, pv_scale,
      static_cast<unsigned long long*>(fallbacks));
  return static_cast<int>(cudaGetLastError());
}

// T <= kOnePass: the one-pass kernel (its K and V^T always fit shared
// memory); longer: the three-pass kernel, K and V^T resident when they fit
// kResidentBytes, else streamed.
template <int HD>
int launch(const void* qkv, void* y, int n, int t, int heads, float qk_scale, float pv_scale,
           void* fallbacks, void* stream) {
  if (t <= kOnePass)
    return launch_kernel<OnePass<HD>, false>(qkv, y, n, t, heads, qk_scale, pv_scale,
                                             layout(t, HD, kOnePass), fallbacks, stream);
  const Layout L = layout(t, HD, ThreePass<HD>::CK);
  return L.resident ? launch_kernel<ThreePass<HD>, false>(qkv, y, n, t, heads, qk_scale,
                                                         pv_scale, L, fallbacks, stream)
                    : launch_kernel<ThreePass<HD>, true>(qkv, y, n, t, heads, qk_scale,
                                                        pv_scale, L, fallbacks, stream);
}

}  // namespace

// qkv (N, T, 3*heads*hd) int8, contiguous and 16-byte aligned; y (N, T,
// heads*hd) int8; hd a multiple of 16 up to 128, any T >= 1. qk_scale and
// pv_scale as kernels/qattention.py forms them. fallbacks: null, or a
// uint64 counter to which the launch adds the elements whose division took
// the exact steps. Returns cudaGetLastError().
extern "C" int tf2_qattention(const void* qkv, void* y, int n, int t, int heads, int hd,
                              float qk_scale, float pv_scale, void* fallbacks, void* stream) {
  if (n <= 0 || t <= 0 || heads <= 0 || hd < 16 || hd > 128 || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd / 16) {
    case 1: return launch<16>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
    case 2: return launch<32>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
    case 3: return launch<48>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
    case 4: return launch<64>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
    case 5: return launch<80>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
    case 6: return launch<96>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
    case 7: return launch<112>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
    default: return launch<128>(qkv, y, n, t, heads, qk_scale, pv_scale, fallbacks, stream);
  }
}
