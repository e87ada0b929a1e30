// Fused shift-quantized k x k conv for Hopper, as an implicit GEMM over the
// unpadded NHWC image: y = requant(conv(x, decode(w))), int8 NHWC out.
//
// Replaces tf2_tpu/kernels/qconv.py:
//   tf2_qconv_s1  <- _qconv_s1_kernel (:98, called through _qconv_call :301)
//   tf2_qconv_s2  <- _qconv_s2_kernel (:166, same call)
// and runs the W-pair-packed stem (wfmt "wpack2", graph/optimize.
// pack_phase_stem), which the reference runs as one bf16 lax conv in XLA at
// strides (2, 1) (tf2_tpu/kernels/dispatch.py:154-173), not in Pallas:
//   tf2_qconv_s2x1 <- that conv
// The strides (SH, SW) are template parameters of one kernel (qgemm.cuh). On
// the ResNet-50 path s1 runs the 13 3x3 stride-1 convs; s2 runs the three
// 3x3 stride-2 convs, the three 1x1 stride-2 downsamples and the 7x7 stride-2
// stem on 3 input channels with int8 weights; s2x1 runs the packed stem
// instead of the last when Engine(phase_stem=True): 7x4 taps over 6
// channels, K = 168.
//
// What bounds it on the card: the 3x3 convs do 9*C MACs per input byte and
// are bound by int8 tensor-core operations; the stem (K = 147, 64 output
// channels, 112x112 outputs) and the 1x1 downsamples are bound by memory
// bytes.
//
// What the design does about it: the TPU kernels built padded and
// phase-folded copies of the image in VMEM so that every tap became an
// aligned slice. Here there is no copy: each block gathers its im2col tile
// straight from the NHWC image, with TF-SAME padding (asymmetric at stride 2)
// applied by bounds checks, 16 bytes at a time when C is a multiple of 16
// (every layer but the stems), and feeds int8 MMA with the fused epilogue.
// The stems' C = 3 and C = 6 take the byte-wise gather, the slowest part of
// this kernel. Not done yet: cp.async/TMA pipelining, wgmma. The stem
// kernel that loads whole pixels is qstem.cu.
#include "qgemm.cuh"

namespace {

struct qconv_s1;  // kernel tags, named after the wrappers
struct qconv_s2;
struct qconv_s2x1;

tf2::Args conv_args(const void* x, const void* w, const void* es, const void* eb,
                    void* y, int b, int h, int w_, int c, int oh, int ow, int kh,
                    int kw, int pad_top, int pad_left, int n, int relu) {
  tf2::Args p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.es = static_cast<const float*>(es);
  p.eb = static_cast<const float*>(eb);
  p.y = static_cast<int8_t*>(y);
  p.M = b * oh * ow;
  p.N = n;
  p.K = kh * kw * c;
  p.H = h;
  p.W = w_;
  p.C = c;
  p.OH = oh;
  p.OW = ow;
  p.KW = kw;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.relu = relu;
  return p;
}

template <class Tag, int SH, int SW>
int conv(const void* x, const void* w, const void* es, const void* eb, void* y,
         int b, int h, int w_, int c, int oh, int ow, int kh, int kw, int pad_top,
         int pad_left, int n, int pot4, int relu, void* stream) {
  const tf2::Args p = conv_args(x, w, es, eb, y, b, h, w_, c, oh, ow, kh, kw,
                                pad_top, pad_left, n, relu);
  return pot4 ? tf2::launch<Tag, tf2::CONV, SH, SW, true>(p, stream)
              : tf2::launch<Tag, tf2::CONV, SH, SW, false>(p, stream);
}

}  // namespace

// x (B, H, W, C) int8; w (KH*KW*C/2, N) uint8 split-half PoT codes when pot4,
// else (KH*KW*C, N) int8 in HWIO order; es/eb (N,) f32; y (B, OH, OW, N)
// int8. pad_top/pad_left are the leading TF-SAME pads; the trailing pads
// follow from OH/OW. Returns cudaGetLastError().
extern "C" int tf2_qconv_s1(const void* x, const void* w, const void* es,
                            const void* eb, void* y, int b, int h, int w_, int c,
                            int oh, int ow, int kh, int kw, int pad_top,
                            int pad_left, int n, int pot4, int relu, void* stream) {
  return conv<qconv_s1, 1, 1>(x, w, es, eb, y, b, h, w_, c, oh, ow, kh, kw, pad_top,
                              pad_left, n, pot4, relu, stream);
}

extern "C" int tf2_qconv_s2(const void* x, const void* w, const void* es,
                            const void* eb, void* y, int b, int h, int w_, int c,
                            int oh, int ow, int kh, int kw, int pad_top,
                            int pad_left, int n, int pot4, int relu, void* stream) {
  return conv<qconv_s2, 2, 2>(x, w, es, eb, y, b, h, w_, c, oh, ow, kh, kw, pad_top,
                              pad_left, n, pot4, relu, stream);
}

// Stride 2 along H, 1 along W; the same operands.
extern "C" int tf2_qconv_s2x1(const void* x, const void* w, const void* es,
                              const void* eb, void* y, int b, int h, int w_, int c,
                              int oh, int ow, int kh, int kw, int pad_top,
                              int pad_left, int n, int pot4, int relu, void* stream) {
  return conv<qconv_s2x1, 2, 1>(x, w, es, eb, y, b, h, w_, c, oh, ow, kh, kw, pad_top,
                                pad_left, n, pot4, relu, stream);
}
