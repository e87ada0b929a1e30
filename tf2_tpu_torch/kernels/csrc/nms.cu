// Greedy NMS keep mask for Hopper: one score-sorted row of candidates a
// block.
//
// Replaces the greedy sweep of tf2_tpu/kernels/detection.py:
//   tf2_nms_keep  <- nms_single_class (:72, vmapped by batched_nms :144)
// which the reference runs under XLA (a tiled sweep of jnp ops in a
// while_loop), not as a Pallas kernel. On the SSD path it takes every
// (image, class) row of the top k candidates: R = N * (C - 1) rows of
// k = min(100, priors) = 100 boxes (1,280 rows at batch 64, 21 classes).
//
// What it computes (kernels/detection.py: greedy_keep_plain is the plain
// version): keep[j] = not any(keep[i] and IoU(i, j) > thresh for i < j),
// over boxes already sorted by score (ties: the lower index first) with
// the zero-score candidates' boxes zeroed. The IoU follows the plain
// _pairwise_iou's op order, each f32 step one correctly rounded operation
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn: no contracted FMA), min,
// max and clamp_min(., 0) as torch's minimum, maximum and clamp_min (NaN in,
// NaN out), and thresh is the Python threshold rounded once to f32, as
// torch compares an f32 tensor with a Python float. So the mask equals
// the plain version's bit for bit on the card and on the CPU.
//
// What bounds it on the card: operations, if the sweep were free: at most
// k (k - 1) / 2 IoUs a row of 14 f32 operations each (6.3 M pairs at SSD
// b64: 1.3 us at 67 TFLOP/s; the random scores' rows need 5.1 M), against
// 17 bytes a box (2.2 MB: 0.65 us). What bounds this kernel is the sweep's
// serial depth: k steps a row, each behind a barrier.
//
// What the design does about it (a simple kernel that is right; the
// bitmask rows with one warp's serial scan are later work):
// - one block a row, so the 1,280 rows of SSD b64 spread over the 132 SMs
//   (several blocks resident on each: 2.1 KB of shared memory a row);
// - the row's boxes, their areas and the keep flags staged once in shared
//   memory; then the greedy sweep i = 0 .. k - 1: where keep[i] holds (final
//   by then: only earlier steps write it), each thread clears keep[j] for
//   its j > i, j still kept, whose IoU with box i exceeds thresh, and the
//   block meets at a barrier. A step whose box was suppressed does nothing
//   and needs no barrier (every thread reads the same flag);
// - any k up to tf2_nms_max_k() (the row in the 48 KB of shared memory a
//   block has without an opt-in), k not a multiple of 32 and k above the
//   block size (a thread takes every blockDim-th j).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kBytesPerBox = 4 * 4 + 4 + 1;  // the box, its area, its keep flag

struct nms;  // kernel tag, named after the wrapper

// torch.minimum / torch.maximum / clamp_min: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f), max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU(a, b) in _pairwise_iou's order, a and b xyxy
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b, float area_b) {
  const float iw = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float ih = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, max_nan(uni, 1e-9f));
}

template <class Tag>
__global__ void __launch_bounds__(kMaxThreads)
    nms_keep_kernel(const float* __restrict__ boxes, uint8_t* __restrict__ keep_out, int k,
                    float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + k);
  uint8_t* keep = reinterpret_cast<uint8_t*>(area + k);
  const float* row = boxes + static_cast<int64_t>(blockIdx.x) * k * 4;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 b = make_float4(row[4 * j], row[4 * j + 1], row[4 * j + 2], row[4 * j + 3]);
    box[j] = b;
    area[j] = area_of(b);
    keep[j] = 1;
  }
  __syncthreads();
  for (int i = 0; i < k - 1; ++i) {
    if (!keep[i]) continue;  // the same for every thread: no step, no barrier
    const float4 bi = box[i];
    const float ai = area[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x)
      if (keep[j] && iou(bi, ai, box[j], area[j]) > thresh) keep[j] = 0;
    __syncthreads();
  }
  uint8_t* out = keep_out + static_cast<int64_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) out[j] = keep[j];
}

}  // namespace

extern "C" int tf2_nms_max_k() { return kSmemBytes / kBytesPerBox; }

// boxes (rows, k, 4) f32 xyxy, contiguous, each row sorted by score;
// keep (rows, k) bool (one byte each). thresh: the IoU threshold as f32.
// Returns cudaGetLastError().
extern "C" int tf2_nms_keep(const void* boxes, void* keep, int rows, int k, float thresh,
                            void* stream) {
  if (rows <= 0 || k <= 0 || k > tf2_nms_max_k())
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = k < kMaxThreads ? (k + 31) / 32 * 32 : kMaxThreads;
  nms_keep_kernel<nms><<<rows, threads, k * kBytesPerBox, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}
