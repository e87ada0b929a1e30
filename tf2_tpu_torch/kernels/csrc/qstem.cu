// Fused small-cin stride-2 stem conv for Hopper: NHWC f32 (quantized here
// by a scale) or int8 image in, int8 NHWC out:
//   x_q = clip(rint(x / scale), +-127)        (f32 input; IEEE division)
//   acc = sum over (c, dy, dx) of x_q[2 oy + dy - pad_top, 2 ox + dx - pad_left, c]
//                                  * w[(c, dy, dx)][n]               int32, exact
//   y   = clip(rint(max?(f32(acc) * es + eb, 0)), +-127)
//
// Replaces tf2_tpu/kernels/qstem.py:
//   tf2_qstem  <- _qstem_kernel (:144, called through _qstem_call :184)
// No Engine of either package routes a stem to it; its entry is
// kernels/qstem.fused_qstem, as the reference's is.
//
// What bounds it on the card: memory bytes. At the ResNet-50 stem (7x7,
// cin 3 -> 64, 224x224, batch 64) it reads a 38.5 MB f32 image and writes
// a 51.4 MB int8 output, 0.027 ms at 3.35 TB/s, against 0.0045 ms of int8
// tensor-core work (K = 147).
//
// What the design does about it: the TPU kernel folded the image into
// stride-2 phase planes in XLA first, because Mosaic has no strided loads;
// the card needs no such copy. A block owns one image's band of BR output
// rows: it loads the band's 2 (BR - 1) + k input rows once, as whole pixels
// with the TF-SAME pads written as zeros, quantizing f32 pixels on the way
// into shared memory. Then, 128 output pixels at a time, it builds the
// 128 x Kp patch tile in shared memory from a per-k offset table (K in
// fold_weight's (c, dy, dx) order, zero-padded to Kp, a multiple of 32) and
// runs it against the (Kp, N) weight, 64 output channels at a time, each
// of 8 warps on 16 pixels with mma.sync m16n8k32 s8, then the bit-exact
// epilogue of qgemm.cuh (__fmul_rn, __fadd_rn, rintf, clip). Not done yet:
// coalesced 16-byte output stores through shared memory, overlap of the
// band load with the MMAs, wgmma.
#include "qgemm.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kM = 128;        // output pixels per patch tile, 16 a warp
constexpr int kN = 64;         // output channels per weight chunk

struct qstem;  // kernel tag, named after the wrapper

struct StemArgs {
  const void* x;      // (B, H, W, C) f32 or int8
  const int8_t* w;    // (Kp, N) int8, rows in (c, dy, dx) order
  const float* es;    // (N,)
  const float* eb;    // (N,)
  int8_t* y;          // (B, OH, OW, N)
  float scale;        // the f32 input's quantization scale
  int H, W, C, OH, OW, KH, KW, pad_top, pad_left, N, Kp, BR, relu;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
// row stride of the patch and weight tiles: Kp + 16 bytes keeps the
// fragment loads free of bank conflicts for any Kp that is a multiple of 32
__host__ __device__ inline int ldk(int kp) { return kp + 16; }
__host__ __device__ inline int band_cols(int ow, int kw) { return 2 * (ow - 1) + kw; }
__host__ __device__ inline int band_rows(int br, int kh) { return 2 * (br - 1) + kh; }

// Shared memory: the int8 band, the per-k offsets, the patch tile, the
// weight chunk.
__host__ __device__ inline int koff_base(const StemArgs& p) {
  return round16(band_rows(p.BR, p.KH) * band_cols(p.OW, p.KW) * p.C);
}
__host__ __device__ inline int patch_base(const StemArgs& p) { return koff_base(p) + 4 * p.Kp; }
__host__ __device__ inline int weight_base(const StemArgs& p) {
  return patch_base(p) + kM * ldk(p.Kp);
}
__host__ __device__ inline int smem_bytes(const StemArgs& p) {
  return weight_base(p) + kN * ldk(p.Kp);
}

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// sB[n][k] = w[k][n0 + n] for the chunk's kN columns, 0 past N
__device__ void load_weights(const StemArgs& p, int8_t* sB, int n0) {
  for (int i = threadIdx.x; i < p.Kp * kN; i += kThreads) {
    const int k = i / kN, n = i - k * kN;
    sB[n * ldk(p.Kp) + k] = n0 + n < p.N ? p.w[static_cast<size_t>(k) * p.N + n0 + n] : 0;
  }
}

template <bool F32>
__global__ void __launch_bounds__(kThreads) qstem_kernel(const StemArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* band = smem;
  int* koff = reinterpret_cast<int*>(smem + koff_base(p));
  int8_t* sA = smem + patch_base(p);
  int8_t* sB = smem + weight_base(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, oy0 = blockIdx.x * p.BR;
  const int rows = min(p.BR, p.OH - oy0);
  const int wp = band_cols(p.OW, p.KW), in_rows = band_rows(rows, p.KH);
  const int K = p.C * p.KH * p.KW, lda = ldk(p.Kp);

  // ---- the band: input rows 2 oy0 - pad_top + r, padded columns from
  // -pad_left, whole pixels, zeros outside the image ----
  const int row_len = wp * p.C;
  const int iy0 = 2 * oy0 - p.pad_top;
  for (int i = tid; i < in_rows * row_len; i += kThreads) {
    const int r = i / row_len, e = i - r * row_len;
    const int j = e / p.C, c = e - j * p.C;
    const int iy = iy0 + r, ix = j - p.pad_left;
    int8_t v = 0;
    if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
      const size_t at = ((static_cast<size_t>(b) * p.H + iy) * p.W + ix) * p.C + c;
      v = F32 ? quantize(static_cast<const float*>(p.x)[at], p.scale)
              : static_cast<const int8_t*>(p.x)[at];
    }
    band[i] = v;
  }
  // ---- offset of reduction index k from a pixel's window origin ----
  for (int k = tid; k < p.Kp; k += kThreads) {
    if (k < K) {
      const int c = k / (p.KH * p.KW), r = k - c * (p.KH * p.KW);
      const int dy = r / p.KW, dx = r - dy * p.KW;
      koff[k] = (dy * wp + dx) * p.C + c;
    } else {
      koff[k] = -1;
    }
  }
  const bool resident = p.N <= kN;
  if (resident) load_weights(p, sB, 0);
  __syncthreads();

  const int pixels = rows * p.OW;
  for (int m0 = 0; m0 < pixels; m0 += kM) {
    // ---- patch tile: sA[m][k] = band[origin(m0 + m) + koff[k]] ----
    const int words = p.Kp / 4;
    for (int i = tid; i < kM * words; i += kThreads) {
      const int m = i / words, k = (i - m * words) * 4;
      uint32_t packed = 0;
      if (m0 + m < pixels) {
        const int oyl = (m0 + m) / p.OW, ox = (m0 + m) - oyl * p.OW;
        const int8_t* origin = band + (2 * oyl * wp + 2 * ox) * p.C;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = koff[k + e];
          const uint32_t v = off >= 0 ? static_cast<uint8_t>(origin[off]) : 0u;
          packed |= v << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(sA + m * lda + k) = packed;
    }
    __syncthreads();

    for (int n0 = 0; n0 < p.N; n0 += kN) {
      if (!resident) {
        load_weights(p, sB, n0);
        __syncthreads();
      }
      int acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0;
      for (int ks = 0; ks < p.Kp / 32; ++ks) {
        uint32_t af[4], bf[2];
        const int8_t* pa = sA + (warp * 16 + g) * lda + ks * 32 + t * 4;
        af[0] = *reinterpret_cast<const uint32_t*>(pa);
        af[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * lda);
        af[2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * lda + 16);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int8_t* pb = sB + (j * 8 + g) * lda + ks * 32 + t * 4;
          bf[0] = *reinterpret_cast<const uint32_t*>(pb);
          bf[1] = *reinterpret_cast<const uint32_t*>(pb + 16);
          tf2::mma_s8(acc[j], af, bf);
        }
      }
      // ---- fused requant epilogue, NHWC int8 out ----
      const bool relu = p.relu != 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp * 16 + g + 8 * h;
        if (m >= pixels) continue;
        const int oy = oy0 + m / p.OW, ox = m % p.OW;
        int8_t* out = p.y + ((static_cast<size_t>(b) * p.OH + oy) * p.OW + ox) * p.N;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n0 + j * 8 + t * 2 + c;
            if (n < p.N) out[n] = tf2::requant(acc[j][2 * h + c], p.es[n], p.eb[n], relu);
          }
        }
      }
      if (!resident) __syncthreads();  // before the next chunk's weights
    }
    __syncthreads();  // before the next patch tile
  }
}

StemArgs stem_args(const void* x, const void* w, const void* es, const void* eb, void* y,
                   float scale, int h, int w_, int c, int oh, int ow, int kh, int kw,
                   int pad_top, int pad_left, int n, int kp, int br, int relu) {
  StemArgs p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.es = static_cast<const float*>(es);
  p.eb = static_cast<const float*>(eb);
  p.y = static_cast<int8_t*>(y);
  p.scale = scale;
  p.H = h;
  p.W = w_;
  p.C = c;
  p.OH = oh;
  p.OW = ow;
  p.KH = kh;
  p.KW = kw;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.N = n;
  p.Kp = kp;
  p.BR = br;
  p.relu = relu;
  return p;
}

int max_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}

template <bool F32>
int launch(const StemArgs& p, int batch, void* stream) {
  static int opted_in = 48 * 1024;  // dynamic shared memory this kernel may use
  const int bytes = smem_bytes(p);
  auto kernel = qstem_kernel<F32>;
  if (bytes > opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = bytes;
  }
  const dim3 grid((p.OH + p.BR - 1) / p.BR, batch);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a block's shared memory for these shapes fits what the card lets a
// block opt in to, else 0 (the wrapper then raises).
extern "C" int tf2_qstem_fits(int c, int ow, int kh, int kw, int n, int kp, int br) {
  StemArgs p{};
  p.C = c;
  p.OW = ow;
  p.KH = kh;
  p.KW = kw;
  p.N = n;
  p.Kp = kp;
  p.BR = br;
  return smem_bytes(p) <= max_smem() ? 1 : 0;
}

// x (B, H, W, C) f32 when is_f32 (quantized by `scale`), else int8; w (Kp, N)
// int8 in (c, dy, dx) row order, rows past K zero; es/eb (N,) f32; y (B, OH,
// OW, N) int8. pad_top/pad_left are the leading pads; a block takes br
// output rows. Returns cudaGetLastError().
extern "C" int tf2_qstem(const void* x, const void* w, const void* es, const void* eb,
                         void* y, int is_f32, float scale, int b, int h, int w_, int c,
                         int oh, int ow, int kh, int kw, int pad_top, int pad_left, int n,
                         int kp, int br, int relu, void* stream) {
  if (b <= 0 || oh <= 0 || ow <= 0 || n <= 0 || br <= 0 || kp % 32 ||
      kp < c * kh * kw || !tf2_qstem_fits(c, ow, kh, kw, n, kp, br))
    return static_cast<int>(cudaErrorInvalidValue);
  const StemArgs p = stem_args(x, w, es, eb, y, scale, h, w_, c, oh, ow, kh, kw, pad_top,
                               pad_left, n, kp, br, relu);
  return is_f32 ? launch<true>(p, b, stream) : launch<false>(p, b, stream);
}
