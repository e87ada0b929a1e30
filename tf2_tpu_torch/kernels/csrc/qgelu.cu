// int8 GELU for Hopper: int8 codes in, int8 codes out, one table lookup a
// code, in one pass.
//
// Replaces no Pallas kernel: the reference computes its int8 GELU as a
// gather from a 256-entry table in XLA (tf2_tpu/kernels/dispatch.py,
// qgelu), and the port's plain version (kernels/qgelu.py: qgelu_plain) as
// three eager PyTorch kernels a node: a cast of the codes to int64, an
// int64 + 128 and the gather, 34 bytes of traffic an element. It runs every
// GELU of ViT-B/16 (12 a forward, 3,072 wide) and ConvNeXt-T (18 a forward,
// at 4C).
//
// What it computes: out[i] = table[code + 128] = table[(uint8)(x[i] ^ 0x80)],
// where table is the 256-byte device tensor the plain version gathers from
// (kernels/dispatch.py: _qgelu_table builds it on the CPU). No arithmetic of
// the GELU is done here, so the bits are the plain version's by
// construction.
//
// What bounds it on the card: memory bytes. An element is one byte read and
// one written: ConvNeXt-T's 18 nodes at b64 move 1.098 GB, 0.328 ms at
// 3.35 TB/s; ViT-B/16's 12 move 0.925 GB, 0.276 ms.
//
// What the design does about it:
// - 16-byte loads and stores (uint4), neighbouring threads on neighbouring
//   vectors, and two vectors in flight a thread an iteration: with the
//   grid below, about 8 MB in flight across the 132 SMs;
// - the table in shared memory, copied once a block (64 words, one a thread
//   of the first two warps); a lookup is one ld.shared.u8, at most 2-way
//   bank conflicts (4.2 M lookups an SM at ConvNeXt's b64, under 0.1 ms of
//   instruction time: far below the memory time);
// - a grid-stride loop over min(ceil(n / (threads * 32 bytes)), SMs x
//   blocks resident an SM) blocks: one code path for b64's 77 M-element
//   nodes and b1's 0.6 M-element ones;
// - ordinary stores (not evict-first): the next GEMM reads the output at
//   once, and up to 38.5 MB of it (ConvNeXt stage 2 at b64) stays in the
//   50 MB L2;
// - an input whose pointer is not 16-byte aligned, and a count that is not a
//   multiple of 16, handled here: the bytes before the first aligned vector
//   and after the last one a byte a thread; where x and y differ in their
//   alignment modulo 16 (an input view offset from an aligned output), every
//   byte so.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 256 threads a block, two 16-byte vectors a thread an iteration: 1, 2 or 4
// vectors and 128-1,024 threads a block took 0.368-0.374 ms for ConvNeXt-T's
// 18 nodes at b64, 0.350-0.356 for ViT-B/16's 12 (CUDA graphs; NVIDIA H100
// 80GB HBM3, 700 W): bytes bound it, not the shape of the loop
constexpr int kThreads = 256;
constexpr int kVecs = 2;
constexpr int kBlockBytes = kThreads * 16 * kVecs;

struct qgelu;  // kernel tag, named after the wrapper

__device__ __forceinline__ uint32_t lookup1(const uint8_t* t, int8_t code) {
  return t[static_cast<uint8_t>(code) ^ 0x80u];
}

// Four codes of one 32-bit word, the outputs packed in the same order.
__device__ __forceinline__ uint32_t lookup4(const uint8_t* t, uint32_t w) {
  w ^= 0x80808080u;
  return static_cast<uint32_t>(t[w & 0xffu]) | static_cast<uint32_t>(t[(w >> 8) & 0xffu]) << 8 |
         static_cast<uint32_t>(t[(w >> 16) & 0xffu]) << 16 |
         static_cast<uint32_t>(t[w >> 24]) << 24;
}

__device__ __forceinline__ uint4 lookup16(const uint8_t* t, uint4 v) {
  return make_uint4(lookup4(t, v.x), lookup4(t, v.y), lookup4(t, v.z), lookup4(t, v.w));
}

template <class Tag>
__global__ void __launch_bounds__(kThreads)
    qgelu_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y,
                 const uint32_t* __restrict__ table, long long n) {
  __shared__ uint32_t words[64];
  if (threadIdx.x < 64) words[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const uint8_t* t = reinterpret_cast<const uint8_t*>(words);
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if ((xa ^ reinterpret_cast<uintptr_t>(y)) & 15u) {
    for (long long i = tid; i < n; i += stride) y[i] = static_cast<int8_t>(lookup1(t, x[i]));
    return;
  }
  const long long head = min(static_cast<long long>((16u - (xa & 15u)) & 15u), n);
  const long long vecs = (n - head) >> 4;
  const long long tail = head + (vecs << 4);
  if (tid < head) y[tid] = static_cast<int8_t>(lookup1(t, x[tid]));
  if (tid < n - tail) y[tail + tid] = static_cast<int8_t>(lookup1(t, x[tail + tid]));
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  long long i = tid;
  for (; i + (kVecs - 1) * stride < vecs; i += kVecs * stride) {
    uint4 v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) v[k] = xv[i + k * stride];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) yv[i + k * stride] = lookup16(t, v[k]);
  }
  for (; i < vecs; i += stride) yv[i] = lookup16(t, xv[i]);
}

}  // namespace

// x, y: n int8 codes, contiguous (any alignment); table: the 256 output
// codes, input code + 128 -> output code, 4-byte aligned. Returns
// cudaGetLastError().
extern "C" int tf2_qgelu(const void* x, void* y, const void* table, long long n,
                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(table) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // blocks resident at once: asked once (one kernel, no dynamic shared memory)
  static int fit = 0;
  if (!fit) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qgelu_kernel<qgelu>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    fit = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long want = (n + kBlockBytes - 1) / kBlockBytes;
  qgelu_kernel<qgelu><<<static_cast<unsigned>(want < fit ? want : fit), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(y),
      static_cast<const uint32_t*>(table), n);
  return static_cast<int>(cudaGetLastError());
}
