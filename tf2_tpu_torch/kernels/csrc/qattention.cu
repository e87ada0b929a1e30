// Fused int8 attention core for Hopper: packed qkv (N, T, 3*dim) int8 in,
// (N, T, dim) int8 out, one head of width hd = dim / heads at a time.
//
// Replaces tf2_tpu/kernels/qattention.py:
//   tf2_qattention  <- _qattn_kernel (:42, called through _qattn_call :90)
// On the ViT-B/16 path it runs the 12 attention cores of a forward (T = 196,
// or 197 with the class token; 12 heads of 64).
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
// boundary.
//
// What bounds it on the card: memory bytes, 3*dim + dim bytes a token (the
// int8 qkv read once, the output written once); the two products are
// 4*T*hd multiply-accumulates a token and head, small beside the int8
// tensor-core rate, and the softmax takes T double exps a token and head.
//
// What the design does about it: the TPU kernel kept a batch block of
// images in VMEM and ran every head in a loop. Here a block of 4 warps
// takes one (image, head, 64 query rows): K and V of the head are copied
// into shared memory once (V transposed, so that PV reads it as the B
// operand), each warp computes its 16 query rows' logits with mma.sync
// m16n8k32 s8 into an f32 row buffer in shared memory, takes the softmax of
// its own rows (a warp per row, max and double sum by shuffles), writes p_q
// as int8 beside it and multiplies by V with mma.sync again; only int8
// leaves the block. Not done yet: one K/V copy for all query blocks of a
// head (the 4 query blocks of T = 196 each copy it, from L2), wgmma, TMA.
#include "qgemm.cuh"

namespace {

constexpr int kQ = 64;  // query rows a block: 4 warps of 16
constexpr int kThreads = 128;

struct qattention;  // kernel tag, named after the wrapper

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory of a block, in bytes from its start: Q (kQ rows), K (T8
// rows) with rows of hd padded to 32 plus 16 (conflict-free fragment
// loads), V transposed (hd rows of T padded to 32 plus 16), P (kQ rows of
// the same), then the f32 logits (kQ rows of T8 + 4).
struct Layout {
  int ldq, t8, t32, ldp, lds, k_off, vt_off, p_off, s_off, bytes;
};

__host__ __device__ inline Layout layout(int t, int hd) {
  Layout L;
  L.ldq = round_up(hd, 32) + 16;
  L.t8 = round_up(t, 8);
  L.t32 = round_up(t, 32);
  L.ldp = L.t32 + 16;
  L.lds = L.t8 + 4;
  L.k_off = kQ * L.ldq;
  L.vt_off = L.k_off + L.t8 * L.ldq;
  L.p_off = L.vt_off + hd * L.ldp;
  L.s_off = L.p_off + kQ * L.ldp;
  L.bytes = L.s_off + kQ * L.lds * 4;
  return L;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <class Tag, int NT>  // NT = hd / 8
__global__ void __launch_bounds__(kThreads)
qattn_kernel(const int8_t* __restrict__ qkv, int8_t* __restrict__ y, int t, int heads,
             float qk_scale, float pv_scale) {
  constexpr int HD = NT * 8;
  constexpr int KS = (HD + 31) / 32;  // k32 steps of QK^T
  constexpr int CH = HD / 16;         // 16-byte chunks of a head's row
  extern __shared__ __align__(16) int8_t smem[];
  const Layout L = layout(t, HD);
  int8_t* sQ = smem;
  int8_t* sK = smem + L.k_off;
  int8_t* sVt = smem + L.vt_off;
  int8_t* sP = smem + L.p_off;
  float* sS = reinterpret_cast<float*>(smem + L.s_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kQ, h = blockIdx.y, n = blockIdx.z;
  const int rows = min(kQ, t - q0);
  const int dim = heads * HD;
  const size_t row_stride = 3 * static_cast<size_t>(dim);
  const int8_t* base = qkv + static_cast<size_t>(n) * t * row_stride + h * HD;

  // the int8 buffers read as 0 past hd, past T and past the block's rows
  for (int i = tid; i < L.s_off / 16; i += kThreads)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i - r * CH;
    *reinterpret_cast<int4*>(sQ + r * L.ldq + c * 16) =
        *reinterpret_cast<const int4*>(base + (q0 + r) * row_stride + c * 16);
  }
  for (int i = tid; i < t * CH; i += kThreads) {
    const int j = i / CH, c = i - j * CH;
    const int8_t* src = base + j * row_stride + c * 16;
    *reinterpret_cast<int4*>(sK + j * L.ldq + c * 16) =
        *reinterpret_cast<const int4*>(src + dim);
    tf2::Chunk u;
    u.v = *reinterpret_cast<const int4*>(src + 2 * dim);
#pragma unroll
    for (int e = 0; e < 16; ++e) sVt[(c * 16 + e) * L.ldp + j] = static_cast<int8_t>(u.b[e]);
  }
  __syncthreads();

  // ---- logits of the warp's 16 query rows: Q K^T on the tensor cores ----
  const int mrow = warp * 16;
  uint32_t af[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int8_t* pa = sQ + (mrow + g) * L.ldq + ks * 32 + tq * 4;
    af[ks][0] = ld32(pa);
    af[ks][1] = ld32(pa + 8 * L.ldq);
    af[ks][2] = ld32(pa + 16);
    af[ks][3] = ld32(pa + 8 * L.ldq + 16);
  }
  float* s0 = sS + (mrow + g) * L.lds;
  float* s1 = s0 + 8 * L.lds;
  for (int nt = 0; nt < L.t8 / 8; ++nt) {
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int8_t* pb = sK + (nt * 8 + g) * L.ldq + ks * 32 + tq * 4;
      const uint32_t bf[2] = {ld32(pb), ld32(pb + 16)};
      tf2::mma_s8(acc, af[ks], bf);
    }
    const int col = nt * 8 + 2 * tq;
    s0[col] = __fmul_rn(__int2float_rn(acc[0]), qk_scale);
    s0[col + 1] = __fmul_rn(__int2float_rn(acc[1]), qk_scale);
    s1[col] = __fmul_rn(__int2float_rn(acc[2]), qk_scale);
    s1[col + 1] = __fmul_rn(__int2float_rn(acc[3]), qk_scale);
  }
  __syncwarp();

  // ---- softmax of each of the warp's rows, then p_q as int8 ----
  for (int rr = 0; rr < 16; ++rr) {
    const int r = mrow + rr;
    if (r >= rows) break;
    float* s = sS + r * L.lds;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < t; j += 32) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    double sum = 0.0;
    for (int j = lane; j < t; j += 32) {
      const float e = __double2float_rn(exp(static_cast<double>(__fsub_rn(s[j], mx))));
      s[j] = e;
      sum = __dadd_rn(sum, static_cast<double>(e));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum = __dadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    const float total = __double2float_rn(sum);
    int8_t* p = sP + r * L.ldp;
    for (int j = lane; j < t; j += 32)
      p[j] = static_cast<int8_t>(rintf(__fmul_rn(__fdiv_rn(s[j], total), 127.0f)));
  }
  __syncwarp();

  // ---- P V on the tensor cores, then the requant ----
  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
  for (int ks = 0; ks < L.t32 / 32; ++ks) {
    const int8_t* pa = sP + (mrow + g) * L.ldp + ks * 32 + tq * 4;
    const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * L.ldp), ld32(pa + 16),
                           ld32(pa + 8 * L.ldp + 16)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* pb = sVt + (nt * 8 + g) * L.ldp + ks * 32 + tq * 4;
      const uint32_t bf[2] = {ld32(pb), ld32(pb + 16)};
      tf2::mma_s8(acc[nt], a, bf);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = mrow + g + 8 * hh;
    if (r >= rows) continue;
    int8_t* out = y + (static_cast<size_t>(n) * t + q0 + r) * dim + h * HD;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v = rintf(__fmul_rn(__int2float_rn(acc[nt][2 * hh + c]), pv_scale));
        out[nt * 8 + 2 * tq + c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
      }
  }
}

template <int NT>
int launch(const void* qkv, void* y, int n, int t, int heads, float qk_scale,
           float pv_scale, void* stream) {
  static int opted_in = 48 * 1024;  // dynamic shared memory this kernel may use
  const Layout L = layout(t, NT * 8);
  auto kernel = qattn_kernel<qattention, NT>;
  if (L.bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = L.bytes;
  }
  const dim3 grid((t + kQ - 1) / kQ, heads, n);
  kernel<<<grid, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<int8_t*>(y), t, heads, qk_scale, pv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most tokens a sequence may have at head width hd (a multiple of 16 up
// to 128): the block's shared memory (Layout) within what the card lets a
// block opt in to; 0 if the device cannot be queried.
extern "C" int tf2_qattention_max_tokens(int hd) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  int t = 0;
  while (layout(t + 1, hd).bytes <= optin) ++t;
  return t;
}

// qkv (N, T, 3*heads*hd) int8, contiguous and 16-byte aligned; y (N, T,
// heads*hd) int8. qk_scale and pv_scale as kernels/qattention.py forms them.
// Returns cudaGetLastError().
extern "C" int tf2_qattention(const void* qkv, void* y, int n, int t, int heads, int hd,
                              float qk_scale, float pv_scale, void* stream) {
  if (n <= 0 || t <= 0 || heads <= 0 || hd < 16 || hd > 128 || hd % 16 ||
      t > tf2_qattention_max_tokens(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd / 8) {
    case 2: return launch<2>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
    case 4: return launch<4>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
    case 6: return launch<6>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
    case 8: return launch<8>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
    case 10: return launch<10>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
    case 12: return launch<12>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
    case 14: return launch<14>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
    default: return launch<16>(qkv, y, n, t, heads, qk_scale, pv_scale, stream);
  }
}
