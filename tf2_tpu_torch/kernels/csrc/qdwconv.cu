// Fused int8 depthwise conv for Hopper: NHWC int8 in, NHWC int8 out, a
// k x k window (k 3, 5 or 7) of one channel a weight, stride 1, SAME pads.
//
// Replaces no Pallas kernel: the reference sends grouped convs to XLA
// (tf2_tpu/kernels/dispatch.py:191-251), and so did the port, whose plain
// version is a float64 F.conv2d (kernels/qconv.py: qconv_plain). ConvNeXt-T
// runs 18 of them a forward (7 x 7, C 96-768).
//
// What it computes, per output (n, y, x, c) (kernels/qdwconv.py has the
// plain version):
//   acc = sum_{dy, dx} x[n, y + dy - p, x + dx - p, c] * w[dy, dx, c]
//         (p = (k - 1) / 2, zero outside the image), an exact int32
//   out = clip(rint(max?(f32(acc) * es[c] + eb[c], 0)), +-127)
// the multiply and the add rounded on their own (requant_bits), so the
// result equals the plain version bit for bit.
//
// What bounds it on the card: memory bytes. A b64 node reads and writes
// 64 H W C bytes each way: 38.5 MB at ConvNeXt-T's stage 1, 11.5 us at
// 3.35 TB/s; its 49 MACs an output are 0.94 G there, 0.95 us of int8 tensor
// cores but 57 us of the CUDA cores' 32-bit multiply-adds.
//
// What the design does about it: the sums go to the tensor cores. For one
// channel, a row of 8 outputs is a product with a banded (Toeplitz) matrix:
// out[x0 + j] = sum_dy sum_i in[dy][x0 - p + i] * T_dy[i][j], T_dy[i][j] =
// w[dy][i - j] for 0 <= i - j < k. So one mma.m16n8k32 takes two window rows
// (A: 16 output rows x 16 input columns of the channel for each; B: the two
// rows' T), and (k + 1) / 2 of them give a 16 x 8 tile of outputs.
// - A block takes 32 channels (one 32-byte sector of a pixel) and walks
//   items of 16 output rows of one image, every column (persistent blocks,
//   as many as the card holds at once, shared out among the channel
//   groups). For an item it reads the input rows it needs (16 + k - 1)
//   once, each thread 4 bytes (4 channels) of 4 pixels, the 8 threads of a
//   pixel its 32 contiguous bytes, 4 such reads in flight, and transposes
//   them in registers (byte permutes) into one plane a channel in shared
//   memory, rows of columns, so that an A fragment register (4 columns of
//   one row) is one 32-bit load; the row stride (16 mod 32 bytes) puts the
//   8 rows x 4 columns of a warp's load in 32 banks, the plane stride (an
//   odd number of words) the 8 channel groups of a transposing warp.
// - Each warp takes four of the channels: their B fragments are built once
//   a block from the weights (zero-padded rows in shared memory) and kept
//   in registers; for each item the warp walks the 8-column tiles, one tile
//   of its four channels at a time (four independent MMA chains).
// - The epilogue (f32 steps without a conversion instruction: requant_bits)
//   writes each tile's int8 outputs as 2-byte pairs into the planes over
//   the tile's own columns, whose inputs no later tile reads; the block then
//   transposes them back to NHWC, each pixel's 32 bytes by 8 threads.
// Measured on the card (PERF.md): the compute, which the epilogue's f32
// steps dominate, and the loads and stores run one after the other in a
// block; overlapping them (a copy of the next item in flight, or warps
// specialised to move or to compute) did not shorten a node.
#include <cuda_runtime.h>

#include <cstdint>

#include "qgemm.cuh"

namespace {

constexpr int kChannels = 32;  // channels a block: one 32-byte sector of a pixel
constexpr int kQuads = kChannels / 4;
constexpr int kRows = 16;       // output rows an item: the MMA's M
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChWarp = kChannels / kWarps;  // channels a warp
constexpr int kBatch = 4;  // reads a thread has in flight while loading an item
constexpr int kWeightRow = 32;  // bytes of a zero-padded weight row: w at 8..8+k

struct qdwconv;  // kernel tag, named after the wrapper

struct Args {
  const int8_t* __restrict__ x;
  const int8_t* __restrict__ w;  // HWIO (k, k, 1, C)
  const float* __restrict__ es;
  const float* __restrict__ eb;
  int8_t* __restrict__ y;
  int n, h, w_, c;
  int relu;
  int tiles;  // 8-column output tiles a row: ceil(W / 8)
  int rs;     // plane row stride in bytes (16 mod 32), >= 8 tiles + 8
  int plane;  // plane stride in bytes: rows * rs + 4 (an odd number of words)
};

// The layout of a block's shared memory (kernels/qdwconv.py: smem_bytes).
__host__ __device__ constexpr int in_rows(int k) { return kRows + k - 1; }
__host__ __device__ inline int smem_bytes(int k, int plane) {
  return kChannels * (plane + k * kWeightRow) + 2 * kChannels * static_cast<int>(sizeof(float));
}

// Four words of four bytes (v[i] byte j) -> their transpose (v[j] byte i).
__device__ __forceinline__ void transpose4(uint32_t (&v)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  v[0] = __byte_perm(t0, t1, 0x5410);
  v[1] = __byte_perm(t0, t1, 0x7632);
  v[2] = __byte_perm(t2, t3, 0x5410);
  v[3] = __byte_perm(t2, t3, 0x7632);
}

// The block's channels' k x k weights as zero-padded rows: s_w[ch][dy][8 +
// dx] = w[dy][dx][c0 + ch], 0 elsewhere (the rows' 32 bytes cover the
// offsets 8 + 4t - g that a B fragment reads). Each (dy, dx) reads its
// channels as 8-byte words.
template <int K>
__device__ __forceinline__ void load_weights(const Args& a, int c0, int nch, uint8_t* s_w) {
  for (int i = threadIdx.x; i < kChannels * K * kWeightRow / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(s_w)[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < kChannels / 8 * K * K; i += kThreads) {
    const int tap = i / (kChannels / 8), part = i % (kChannels / 8);
    if (8 * part >= nch) continue;
    const uint2 v = *reinterpret_cast<const uint2*>(a.w + tap * a.c + c0 + 8 * part);
    const int dy = tap / K, dx = tap - dy * K;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s_w[((8 * part + j) * K + dy) * kWeightRow + 8 + dx] =
          static_cast<uint8_t>((j < 4 ? v.x : v.y) >> (8 * (j & 3)));
  }
}

// One output of the epilogue as its int8 code in the low byte: f32(acc) *
// es + eb, relu, clip to +-127, round half to even, each step one IEEE
// operation, without a conversion instruction: |acc| < 2^22 (a k x k window
// of int8 products, k <= 7), so 1.5 * 2^23 + acc is exact in f32 and its bits
// are those of the integer 0x4B400000 + acc; and adding 1.5 * 2^23 to a
// clipped y rounds it to an integer half to even (the f32 spacing there is
// 1), whose low byte is the code. Clipping before rounding gives what
// rounding before clipping gives, as +-127 are integers.
__device__ __forceinline__ uint32_t requant_bits(int acc, float es, float eb, bool relu) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  float v = __fsub_rn(__int_as_float(0x4B400000 + acc), kMagic);
  v = __fadd_rn(__fmul_rn(v, es), eb);
  if (relu) v = fmaxf(v, 0.0f);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.0f), 127.0f), kMagic));
}

// The A fragment of window rows dy and dy + 1 (k32: columns 0-15 row dy,
// 16-31 row dy + 1) at 8-column tile xt of a plane, for lane (g, t); past
// the last row, row dy again (its B half is 0).
template <int K>
__device__ __forceinline__ void a_fragment(const uint8_t* p, int rs, int dy,
                                           uint32_t (&fa)[4]) {
  fa[0] = *reinterpret_cast<const uint32_t*>(p);
  fa[1] = *reinterpret_cast<const uint32_t*>(p + 8 * rs);
  if (dy + 1 < K) {
    fa[2] = *reinterpret_cast<const uint32_t*>(p + rs);
    fa[3] = *reinterpret_cast<const uint32_t*>(p + 9 * rs);
  } else {
    fa[2] = fa[0];
    fa[3] = fa[1];
  }
}

// Persistent blocks: blockIdx.x picks the 32 channels, and the block walks
// the (image, 16-row band) items blockIdx.y, + gridDim.y, ..., so that its
// weights and B fragments are set up once.
template <class Tag, int K>
__global__ void __launch_bounds__(kThreads) qdwconv_kernel(Args a) {
  constexpr int P = (K - 1) / 2;
  constexpr int R = in_rows(K);
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_in = smem;                       // [32][plane]: rows R of rs bytes
  uint8_t* s_w = s_in + kChannels * a.plane;  // [32][K][32]
  float* s_es = reinterpret_cast<float*>(s_w + kChannels * K * kWeightRow);
  float* s_eb = s_es + kChannels;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChannels;
  const int nch = min(kChannels, a.c - c0);  // 8, 16, 24 or 32
  const int pitch = a.c;                     // bytes from one pixel to the next
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  load_weights<K>(a, c0, nch, s_w);
  if (tid < kChannels) {
    s_es[tid] = tid < nch ? a.es[c0 + tid] : 0.0f;
    s_eb[tid] = tid < nch ? a.eb[c0 + tid] : 0.0f;
  }
  __syncthreads();
  // B fragment of window row dy of the warp's channel i (warp + 8 i): bytes
  // j of lane (g, t) = T_dy[4t + j][g] = w[dy][4t + j - g], four bytes of
  // the padded row from 8 + 4t - g; 0 past the last row
  uint32_t b[kChWarp][K + 1];
  float es[kChWarp], eb[kChWarp];
  const int off = 8 + 4 * t - g;
#pragma unroll
  for (int i = 0; i < kChWarp; ++i) {
    const int ch = warp + kWarps * i;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(s_w + (ch * K + dy) * kWeightRow);
      b[i][dy] = __funnelshift_r(row[off >> 2], row[(off >> 2) + 1], 8 * (off & 3));
    }
    b[i][K] = 0u;
    es[i] = s_es[ch];
    eb[i] = s_eb[ch];
  }
  const bool relu = a.relu != 0;

  const int bands = (a.h + kRows - 1) / kRows;
  const int groups = 2 * a.tiles + 2, out_groups = 2 * a.tiles;
  const int q = tid % kQuads;  // the 4 channels a thread moves: 4q .. 4q + 3
  const bool q_live = 4 * q < nch;
  for (long long item = blockIdx.y; item < static_cast<long long>(a.n) * bands;
       item += gridDim.y) {
    const long long img = item / bands;
    const int y0 = static_cast<int>(item - img * bands) * kRows;
    // the input rows y0 - P .. y0 + 15 + P, columns -P .. 8 tiles + 7 - P
    // (column x at plane byte x + P) into the channel planes: a thread
    // reads 4 bytes (4 channels) of 4 pixels, the 8 threads of a pixel its
    // 32 contiguous bytes, and stores 4 columns of each of its channels;
    // kBatch such reads issued before the first is used
    constexpr int kStep = kThreads / kQuads;
    for (int it0 = tid / kQuads; it0 < R * groups; it0 += kBatch * kStep) {
      uint32_t v[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int it = it0 + u * kStep;
        const int r = it / groups, j = it - r * groups;
        const int yy = y0 - P + r;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int xx = 4 * j + i - P;
          v[u][i] = 0u;
          if (q_live && it < R * groups && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w_)
            v[u][i] = *reinterpret_cast<const uint32_t*>(
                a.x + ((img * a.h + yy) * a.w_ + xx) * pitch + c0 + 4 * q);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int it = it0 + u * kStep;
        if (it >= R * groups) break;
        const int r = it / groups, j = it - r * groups;
        transpose4(v[u]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          *reinterpret_cast<uint32_t*>(s_in + (4 * q + cc) * a.plane + r * a.rs + 4 * j) =
              v[u][cc];
      }
    }
    __syncthreads();
    // each warp: its 4 channels, one 16 x 8 tile of each at a time (four
    // independent MMA chains); tile xt's outputs go into the planes over
    // columns 8 xt .. 8 xt + 7, whose inputs no later tile reads
    for (int xt = 0; xt < a.tiles; ++xt) {
      int acc[kChWarp][4] = {};
#pragma unroll
      for (int dy = 0; dy < K; dy += 2) {
#pragma unroll
        for (int i = 0; i < kChWarp; ++i) {
          uint32_t fa[4];
          a_fragment<K>(s_in + (warp + kWarps * i) * a.plane + (g + dy) * a.rs + 8 * xt + 4 * t,
                        a.rs, dy, fa);
          const uint32_t fb[2] = {b[i][dy], b[i][dy + 1 < K ? dy + 1 : K]};
          tf2::mma_s8(acc[i], fa, fb);
        }
      }
      // acc[i][0], [1]: row g, columns 8 xt + 2t and + 1; [2], [3]: row g + 8
#pragma unroll
      for (int i = 0; i < kChWarp; ++i) {
        uint8_t* o = s_in + (warp + kWarps * i) * a.plane + 8 * xt + 2 * t;
        const uint32_t lo = __byte_perm(requant_bits(acc[i][0], es[i], eb[i], relu),
                                        requant_bits(acc[i][1], es[i], eb[i], relu), 0x40);
        const uint32_t hi = __byte_perm(requant_bits(acc[i][2], es[i], eb[i], relu),
                                        requant_bits(acc[i][3], es[i], eb[i], relu), 0x40);
        *reinterpret_cast<uint16_t*>(o + g * a.rs) = static_cast<uint16_t>(lo);
        *reinterpret_cast<uint16_t*>(o + (g + 8) * a.rs) = static_cast<uint16_t>(hi);
      }
    }
    __syncthreads();
    // the outputs (plane rows 0-15, columns 0 .. W - 1) back to NHWC: a
    // thread reads 4 columns of its 4 channels and writes 4 bytes of 4
    // pixels, the 8 threads of a pixel its 32 contiguous bytes
    for (int it = tid / kQuads; it < kRows * out_groups; it += kThreads / kQuads) {
      const int m = it / out_groups, j = it - m * out_groups;
      const int yy = y0 + m;
      if (yy >= a.h || !q_live) continue;
      uint32_t v[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        v[cc] = *reinterpret_cast<const uint32_t*>(s_in + (4 * q + cc) * a.plane + m * a.rs +
                                                   4 * j);
      transpose4(v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xx = 4 * j + i;
        if (xx < a.w_)
          *reinterpret_cast<uint32_t*>(a.y + ((img * a.h + yy) * a.w_ + xx) * pitch + c0 +
                                       4 * q) = v[i];
      }
    }
    __syncthreads();  // the next item's loads overwrite the planes
  }
}

int round_to(int v, int mod, int rem) {  // the least r >= v with r % mod == rem
  const int r = v - v % mod + rem;
  return r >= v ? r : r + mod;
}

template <int K>
cudaError_t launch(Args a, int sms, cudaStream_t stream) {
  auto kernel = qdwconv_kernel<qdwconv, K>;
  const int smem = smem_bytes(K, a.plane);
  // dynamic shared memory the kernel may take, and the blocks an SM holds
  // at that size (asked once for each)
  static int opted = 48 * 1024;
  static struct { int smem, per_sm; } seen[8];
  static int n_seen = 0;
  if (smem > opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  int per_sm = 0;
  for (int i = 0; i < n_seen && !per_sm; ++i)
    if (seen[i].smem == smem) per_sm = seen[i].per_sm;
  if (!per_sm) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    per_sm = per_sm > 0 ? per_sm : 1;
    if (n_seen < 8) seen[n_seen++] = {smem, per_sm};
  }
  // every channel group gets an equal share of the resident blocks, each
  // walking its (image, band) items
  const int cgroups = (a.c + kChannels - 1) / kChannels;
  const long long items = static_cast<long long>(a.n) * ((a.h + kRows - 1) / kRows);
  const long long share = (static_cast<long long>(per_sm) * sms + cgroups - 1) / cgroups;
  const int per_group = static_cast<int>(share < items ? share : items);
  kernel<<<dim3(cgroups, per_group), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The shared memory a block takes for a k x k conv over rows of w pixels
// (kernels/qdwconv.py: smem_bytes mirrors it).
extern "C" int tf2_qdwconv_smem(int k, int w) {
  const int tiles = (w + 7) / 8;
  return smem_bytes(k, in_rows(k) * round_to(8 * tiles + 8, 32, 16) + 4);
}

// x, y (N, H, W, C) int8, contiguous, 4-byte aligned, C % 8 == 0; w (k, k,
// 1, C) int8, 8-byte aligned; es, eb (C,) f32. Returns cudaGetLastError().
extern "C" int tf2_qdwconv(const void* x, const void* w, const void* es, const void* eb,
                           void* y, int n, int h, int wd, int c, int k, int relu,
                           void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 4 || reinterpret_cast<uintptr_t>(y) % 4 ||
      reinterpret_cast<uintptr_t>(w) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.es = static_cast<const float*>(es);
  a.eb = static_cast<const float*>(eb);
  a.y = static_cast<int8_t*>(y);
  a.n = n;
  a.h = h;
  a.w_ = wd;
  a.c = c;
  a.relu = relu;
  a.tiles = (wd + 7) / 8;
  a.rs = round_to(8 * a.tiles + 8, 32, 16);
  a.plane = in_rows(k) * a.rs + 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return static_cast<int>(launch<3>(a, sms, s));
    case 5: return static_cast<int>(launch<5>(a, sms, s));
    case 7: return static_cast<int>(launch<7>(a, sms, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
