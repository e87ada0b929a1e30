// Fused int8 LRN across channels for Hopper: int8 NHWC in, int8 out.
//
// Replaces tf2_tpu/kernels/qlrn.py:
//   tf2_qlrn  <- _qlrn_kernel (:66, called through _qlrn_call :83)
// On the GoogLeNet path it runs the two LRN layers (lrn_0 on 64 channels,
// lrn_1 on 192, both at 56x56).
//
// What it computes, per element (kernels/qlrn.py has the plain version):
//   xf  = f32(q) * s_in;  sq = xf * xf
//   win = the channel window [c - r, c + r] of sq, summed in double and
//         rounded once to f32
//   t   = bias + alpha * win
//   y   = (xf * rs) * sqrt(rs), rs = 1 / sqrt(t)          (beta = 0.75)
//   y   = xf / f32(exp(beta * log(double(t))))            (any other beta)
//   out = clip(rint(y / s_out), +-127)
// Each f32 step is one correctly rounded operation (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn: no contracted FMA, no approximate rsqrt), so the
// result equals the plain PyTorch version bit for bit on the card and on
// the CPU. t^beta for another beta is the double-precision log and exp the
// plain version calls (torch.log, torch.exp), rounded once to f32: on the
// card the two agree bit for bit; the CPU's libm may round the double
// differently in its last bit.
//
// The window sum is exact, in any order. xf and sq depend on the code q
// only (255 values, 256 with -128): each nonzero sq is an integer multiple
// of u, the last-place unit of the smallest nonzero square (every larger
// square has a unit at least as large), and below 2^14 * 2^24 u = 2^38 u
// (|q| <= 128, so the squares span at most 2^14, with a 24-bit
// significand). A sum of at most C <= 8,181 (tf2_qlrn_max_channels) such
// terms, or any partial sum of them, is a multiple of u below 2^51 u, so a
// double holds it exactly: a running sum that adds the entering square and
// subtracts the leaving one equals the plain version's window sum bit for
// bit, and rounding it once to f32 gives the same win.
//
// What bounds it on the card: memory bytes (each int8 input read once, each
// output written once), if an element costs few enough instructions: 51.4
// M elements a GoogLeNet b64 forward move 103 MB, 31 us at 3.35 TB/s.
//
// What the design does about it:
// - one exact window sum an element: a thread owns a run of 16 consecutive
//   channels of one pixel, sums the first window (2r + 1 squares) and then
//   slides it along the run, one add and one subtract an element. The fast
//   kernel (qlrn_fast: beta 0.75, radius 1 or 2, C % 16 == 0, both tensors
//   16-byte aligned; GoogLeNet's path) reads the run in one 16-byte read
//   and squares each code in registers as it enters the window; the
//   generic kernel (qlrn_kernel: every other case) reads codes byte by byte
//   and looks up per-code tables built once a block in shared memory (sq as
//   a double, xf, xz = f32(xf * (1 / s_out)));
// - a certified fast epilogue (beta = 0.75): z = xz * t^-0.75, with
//   r1 = rsqrtf(t) and t^-0.75 = r1 * (r1 * rsqrtf(r1)). rsqrtf is within 2
//   ulp (CUDA's documented bound, 2^-22 relative), so z is within 2^-20 of
//   xf * t^-0.75 / s_out (relative, first order: 1.5 * 2^-22 from r1, which
//   enters as r1^1.5, 2^-22 from rsqrtf(r1), 2^-24 from each of the three
//   products and of xz's two roundings), and the plain version's correctly
//   rounded steps are within 7 * 2^-24 of it, so the two differ by less
//   than 2^-19 |z|. Where z lies farther than cert * |z| (cert = 2^-17,
//   kernels/qlrn.py: CERT_REL, passed in) from every half-integer, the
//   rounding of the two agrees and rint(z) is the answer (fast_075); any
//   other element (z near a half-integer, or t outside [2^-40, 2^40])
//   takes the exact steps above. The exact path's elements
//   can be counted (slow_count);
// - persistent blocks, each walking runs of whole pixels (about 4 KB)
//   through a two-slot cp.async ring, so that the next run's copy overlaps
//   the arithmetic; the output run leaves 16 bytes a store.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRunBytes = 4096;  // target bytes of one run of pixels
constexpr int kChunk = 16;       // channels a thread slides its window over

struct qlrn;  // kernel tag, named after the wrapper

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Shared memory of a block for runs of `run` bytes: the tables (sq as
// doubles, xf, xz), two input slots and the output slot, each a run with up
// to 15 bytes of lead (the run's address modulo 16) and a 16-byte tail.
constexpr int kTables = 256 * 8 + 256 * 4 * 2;
__host__ __device__ inline int slot_bytes(int run) { return round16(run + 32); }
__host__ __device__ inline int smem_bytes(int run) { return kTables + 3 * slot_bytes(run); }

struct Args {
  const int8_t* x;
  int8_t* y;
  int m, c, radius, pixels, runs;
  float s_in, s_out, alpha, bias, cert;
  double beta;
  int* slow_count;  // exact-path elements, counted where not null
};

// The copies of run r's whole 16-byte granules into slot (at the run's
// address modulo 16). A granule that holds a byte of the tensor lies inside
// one page, so reading its other bytes cannot fault; they are never used.
__device__ __forceinline__ void fetch_run(const Args& a, int r, int8_t* slot) {
  const long long start = static_cast<long long>(r) * a.pixels * a.c;
  const int n = static_cast<int>(min(static_cast<long long>(a.pixels) * a.c,
                                     static_cast<long long>(a.m) * a.c - start));
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a.x + start) & ~uintptr_t(15);
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(a.x + start + n) + 15) & ~uintptr_t(15);
  const int words = static_cast<int>((hi - lo) >> 4);
  for (int i = threadIdx.x; i < words; i += kThreads)
    tf2::cp_async(slot + 16 * i, reinterpret_cast<const void*>(lo + 16 * i), 16, true);
}

// Copy n bytes from shared memory to dst, both at the same offset modulo
// 16: bytes up to the first 16-byte boundary, then 16-byte words, then the
// tail.
__device__ void store_run(int8_t* dst, const int8_t* src, int n) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  const int words = (n - head) >> 4;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < words; i += kThreads) d4[i] = s4[i];
  for (int i = head + (words << 4) + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

__device__ __forceinline__ int8_t clip127(float q) {
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// The exact steps at beta = 0.75 (the fast kernel's rare fallback, kept out
// of its unrolled loop)
__device__ __noinline__ int8_t exact_075(float xf, float t, float s_out) {
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(t));
  const float v = __fmul_rn(__fmul_rn(xf, rs), __fsqrt_rn(rs));
  return clip127(rintf(__fdiv_rn(v, s_out)));
}

// The certified fast epilogue of one element (beta = 0.75, header),
// branch-free: the int8 output's byte of the fast value z = xz * t^-0.75,
// and whether it is certified. clip(rint(z)) = rint(zc), zc = z clipped to
// +-127 (the bounds are integers), and it is the low byte of zc + 1.5 * 2^23
// (the addition rounds half to even), so no conversion instruction is
// needed. zc is certified where it lies farther than cert * |zc| from
// every half-integer: zc - rint(zc) is exact, and the sign of
// cert * |zc| + (|zc - rint(zc)| - 1/2), rounded once, is that of the exact
// value or zero (not certified). A clipped zc = +-127 is certified: the
// exact steps' z is then above 126.99 in magnitude. Only half-integers
// bound the rounding, so a z too small for the relative bound (below 2^-20)
// is far from them and rounds to 0 on both sides.
__device__ __forceinline__ bool fast_075(float xz, float t, float cert, uint32_t& byte) {
  const float r1 = rsqrtf(t);
  const float zc = fminf(fmaxf(xz * (r1 * (r1 * rsqrtf(r1))), -127.0f), 127.0f);
  const float zb = __fadd_rn(zc, 12582912.0f);
  const float off = __fsub_rn(zc, __fsub_rn(zb, 12582912.0f));  // zc - rint(zc)
  byte = __float_as_uint(zb) & 0xFFu;
  return t >= 0x1p-40f && t <= 0x1p40f &&
         __fmaf_rn(cert, fabsf(zc), __fsub_rn(fabsf(off), 0.5f)) < 0.0f;
}

// f32(q) of an int8 code q without a conversion instruction: 1.5 * 2^23 + q
// is exact, and so is the subtraction.
__device__ __forceinline__ float code_f32(uint32_t word, int byte) {
  const int q = static_cast<int8_t>(word >> (8 * byte));
  return __fsub_rn(__int_as_float(0x4B400000 + q), 12582912.0f);
}

// The exact steps for element i (0 .. 15) of a fast kernel's run, out of
// line: its window re-summed from the codes (w: the word before the run, the
// run's four words, the word after, zero outside the pixel).
__device__ __noinline__ uint32_t exact_at(const Args& a, uint32_t w0, uint4 mid, uint32_t w5,
                                          int i) {
  const uint32_t w[6] = {w0, mid.x, mid.y, mid.z, mid.w, w5};
  auto xf = [&](int c) {  // channel c of the run, -4 <= c < 20
    const int b = c + 4;
    return __fmul_rn(static_cast<float>(static_cast<int8_t>(w[b >> 2] >> (8 * (b & 3)))), a.s_in);
  };
  double acc = 0.0;
  for (int j = i - a.radius; j <= i + a.radius; ++j) {
    const float x = xf(j);
    acc += static_cast<double>(__fmul_rn(x, x));
  }
  const float t = __fadd_rn(__fmul_rn(__double2float_rn(acc), a.alpha), a.bias);
  return static_cast<uint8_t>(exact_075(xf(i), t, a.s_out));
}

// beta = 0.75, radius R, C % 16 == 0 and both tensors 16-byte aligned (the
// GoogLeNet path): a thread takes a 16-channel run of a pixel in one 16-byte
// read, with its R-channel halo from the neighbouring words (zero at the
// pixel's edges), squares each code once as it enters the window, slides
// the exact window along the run, and writes its 16 outputs in one 16-byte
// store. The 16 fast epilogues are branch-free, so their latencies overlap;
// the few uncertified elements are redone after.
template <class Tag, int R>
__global__ void __launch_bounds__(kThreads, 3)
qlrn_fast(const Args a) {
  static_assert(R >= 1 && R <= 4, "the halo is one word a side");
  extern __shared__ __align__(16) int8_t smem[];
  const int run = a.pixels * a.c, sb = slot_bytes(run);
  int8_t* const s_out = smem + kTables + 2 * sb;
  const float inv_s = __frcp_rn(a.s_out);
  const int nch = a.c / kChunk;
  // this thread's tasks in every run: (pixel p0, chunk j0), then a step of
  // kThreads chunks, dp pixels and dj chunks on
  const int p0 = threadIdx.x / nch, j0 = threadIdx.x % nch;
  const int dp = kThreads / nch, dj = kThreads % nch;
  int slow = 0;
  int s = 0;
  if (static_cast<int>(blockIdx.x) < a.runs) fetch_run(a, blockIdx.x, smem + kTables);
  tf2::cp_commit();
  for (int r = blockIdx.x; r < a.runs; r += gridDim.x, s ^= 1) {
    if (r + static_cast<int>(gridDim.x) < a.runs)
      fetch_run(a, r + gridDim.x, smem + kTables + (s ^ 1) * sb);
    tf2::cp_commit();
    tf2::cp_wait<1>();
    __syncthreads();  // run r in place
    const int8_t* const in = smem + kTables + s * sb;
    const int np = static_cast<int>(min(static_cast<long long>(a.pixels), a.m - static_cast<long long>(r) * a.pixels));
    for (int p = p0, j = j0; p < np; p += dp, j += dj) {
      if (j >= nch) {
        j -= nch;
        ++p;
        if (p >= np) break;
      }
      const int off = p * a.c + j * kChunk;
      const int8_t* base = in + off;
      const uint4 mid = *reinterpret_cast<const uint4*>(base);
      const uint32_t w0 = j > 0 ? *reinterpret_cast<const uint32_t*>(base - 4) : 0u;
      const uint32_t w5 = j + 1 < nch ? *reinterpret_cast<const uint32_t*>(base + kChunk) : 0u;
      const uint32_t w[6] = {w0, mid.x, mid.y, mid.z, mid.w, w5};
      // code i = -R .. 15 + R of the run is byte i + 4 of w; each enters
      // once, as the window reaches it (only the window's squares are live),
      // and the window sums exactly in double (header)
      double sq[kChunk + 2 * R];
      float xf[kChunk + 2 * R];
      auto enter = [&](int i) {
        xf[i + R] = __fmul_rn(code_f32(w[(i + 4) >> 2], (i + 4) & 3), a.s_in);
        sq[i + R] = static_cast<double>(__fmul_rn(xf[i + R], xf[i + R]));
      };
#pragma unroll
      for (int i = -R; i <= R; ++i) enter(i);
      double acc = sq[0];
#pragma unroll
      for (int i = 1; i <= 2 * R; ++i) acc += sq[i];
      uint32_t o[4] = {0u, 0u, 0u, 0u}, exact = 0u;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float t = __fadd_rn(__fmul_rn(__double2float_rn(acc), a.alpha), a.bias);
        uint32_t v;
        exact |= fast_075(__fmul_rn(xf[i + R], inv_s), t, a.cert, v) ? 0u : 1u << i;
        o[i >> 2] |= v << (8 * (i & 3));
        if (i + 1 < kChunk) {  // slide the window to i + 1
          enter(i + R + 1);
          acc += sq[i + 2 * R + 1];
          acc -= sq[i];
        }
      }
      if (exact) {
        slow += __popc(exact);
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (exact & (1u << i)) {
            const int sh = 8 * (i & 3);
            o[i >> 2] = (o[i >> 2] & ~(0xFFu << sh)) | (exact_at(a, w0, mid, w5, i) << sh);
          }
      }
      *reinterpret_cast<uint4*>(s_out + off) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    store_run(a.y + static_cast<long long>(r) * run, s_out, np * a.c);
  }
  tf2::cp_wait<0>();
  if (a.slow_count) {
    for (int off = 16; off; off >>= 1) slow += __shfl_down_sync(0xffffffffu, slow, off);
    if ((threadIdx.x & 31) == 0 && slow) atomicAdd(a.slow_count, slow);
  }
}

// BETA_075 is a template argument, so the beta = 0.75 kernel carries none of
// the other path's double exp and log (and keeps its registers and speed)
template <class Tag, bool BETA_075>
__global__ void __launch_bounds__(kThreads)
qlrn_kernel(const Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  double* s_sq = reinterpret_cast<double*>(smem);
  float* s_xf = reinterpret_cast<float*>(smem + 256 * 8);
  float* s_xz = s_xf + 256;
  const int run = a.pixels * a.c, sb = slot_bytes(run);
  int8_t* slots[2] = {smem + kTables, smem + kTables + sb};
  int8_t* s_out = smem + kTables + 2 * sb;
  {
    const int q = static_cast<int>(threadIdx.x) - 128;  // kThreads == 256 codes
    const float xf = __fmul_rn(static_cast<float>(q), a.s_in);
    s_xf[threadIdx.x] = xf;
    s_sq[threadIdx.x] = static_cast<double>(__fmul_rn(xf, xf));
    s_xz[threadIdx.x] = __fmul_rn(xf, __frcp_rn(a.s_out));
  }
  const int nch = (a.c + kChunk - 1) / kChunk;
  int slow = 0;
  int s = 0;
  if (static_cast<int>(blockIdx.x) < a.runs) fetch_run(a, blockIdx.x, slots[0]);
  tf2::cp_commit();
  for (int r = blockIdx.x; r < a.runs; r += gridDim.x, s ^= 1) {
    if (r + static_cast<int>(gridDim.x) < a.runs) fetch_run(a, r + gridDim.x, slots[s ^ 1]);
    tf2::cp_commit();
    tf2::cp_wait<1>();
    __syncthreads();  // run r (and, the first time, the tables) in place
    const long long start = static_cast<long long>(r) * run;
    const int np = static_cast<int>(min(static_cast<long long>(a.pixels), a.m - static_cast<long long>(r) * a.pixels));
    const int8_t* in = slots[s] + (reinterpret_cast<uintptr_t>(a.x + start) & 15);
    int8_t* out = s_out + (reinterpret_cast<uintptr_t>(a.y + start) & 15);
    for (int task = threadIdx.x; task < np * nch; task += kThreads) {
      const int p = task / nch, c0 = (task - p * nch) * kChunk;
      const int c1 = min(c0 + kChunk, a.c);
      const int8_t* px = in + p * a.c;
      int8_t* po = out + p * a.c;
      double acc = 0.0;
      const int w1 = min(c0 + a.radius, a.c - 1);
      for (int j = max(c0 - a.radius, 0); j <= w1; ++j) acc += s_sq[px[j] + 128];
      for (int ch = c0; ch < c1; ++ch) {
        const int q = px[ch] + 128;
        const float t = __fadd_rn(__fmul_rn(__double2float_rn(acc), a.alpha), a.bias);
        const float xf = s_xf[q];
        int8_t o;
        uint32_t v;
        if (BETA_075 && fast_075(s_xz[q], t, a.cert, v)) {
          o = static_cast<int8_t>(v);
        } else if (BETA_075) {
          o = exact_075(xf, t, a.s_out);
          ++slow;
        } else {
          const float v = __fdiv_rn(
              xf, __double2float_rn(exp(__dmul_rn(a.beta, log(static_cast<double>(t))))));
          o = clip127(rintf(__fdiv_rn(v, a.s_out)));
          ++slow;
        }
        po[ch] = o;
        // slide the window to ch + 1
        if (ch + a.radius + 1 < a.c) acc += s_sq[px[ch + a.radius + 1] + 128];
        if (ch - a.radius >= 0) acc -= s_sq[px[ch - a.radius] + 128];
      }
    }
    __syncthreads();
    store_run(a.y + start, out, np * a.c);
  }
  tf2::cp_wait<0>();
  if (a.slow_count) {
    for (int off = 16; off; off >>= 1) slow += __shfl_down_sync(0xffffffffu, slow, off);
    if ((threadIdx.x & 31) == 0 && slow) atomicAdd(a.slow_count, slow);
  }
}

}  // namespace

// The most channels a pixel may have: one pixel's squares, input and output
// within the 48 KB of shared memory a block gets without opting in (the
// bound of the exact window sum above holds far beyond it).
extern "C" int tf2_qlrn_max_channels() { return (48 * 1024 - 64) / 6; }

// x, y (M, C) int8, contiguous; the window takes `radius` channels on each
// side. Scalars are f32; beta_075 selects the beta = 0.75 steps (with the
// certified epilogue, bound cert), else beta is the f32 exponent as a
// double. slow_count: an int32 on the card that counts the elements taken
// by the exact steps, or null. Returns cudaGetLastError().
extern "C" int tf2_qlrn(const void* x, void* y, int m, int c, int radius, float s_in,
                        float s_out, float alpha, float bias, int beta_075, double beta,
                        float cert, void* slow_count, void* stream) {
  if (m <= 0 || c <= 0 || radius < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (c > tf2_qlrn_max_channels()) return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.y = static_cast<int8_t*>(y);
  a.m = m;
  a.c = c;
  a.radius = radius;
  a.pixels = c >= kRunBytes ? 1 : kRunBytes / c;
  a.runs = (m + a.pixels - 1) / a.pixels;
  a.s_in = s_in;
  a.s_out = s_out;
  a.alpha = alpha;
  a.bias = bias;
  a.cert = cert;
  a.beta = beta;
  a.slow_count = static_cast<int*>(slow_count);
  const int smem = smem_bytes(a.pixels * c);
  const bool aligned = c % kChunk == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  auto kernel = !beta_075                                ? qlrn_kernel<qlrn, false>
                : !aligned || radius < 1 || radius > 2 ? qlrn_kernel<qlrn, true>
                : radius == 1                          ? qlrn_fast<qlrn, 1>
                                                       : qlrn_fast<qlrn, 2>;
  // persistent blocks: as many as are resident at once on the card (asked
  // once for each kernel and shared-memory size)
  static struct { const void* kernel; int smem, per_sm; } seen[16];
  static int n_seen = 0;
  int per_sm = 0;
  for (int i = 0; i < n_seen && !per_sm; ++i)
    if (seen[i].kernel == reinterpret_cast<const void*>(kernel) && seen[i].smem == smem)
      per_sm = seen[i].per_sm;
  if (!per_sm) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm = per_sm > 0 ? per_sm : 1;
    if (n_seen < 16) seen[n_seen++] = {reinterpret_cast<const void*>(kernel), smem, per_sm};
  }
  const int fit = per_sm * sms;
  const unsigned blocks = static_cast<unsigned>(a.runs < fit ? a.runs : fit);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
