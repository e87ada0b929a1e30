// Shared core of the port's int8 kernels for Hopper (sm_90a), included by
// qmm_int8.cuh and qmm_pot4.cuh (the GEMMs of shift_matmul.cu),
// qconv_pipe.cuh (the conv kernels), qblocks.cu (the chain kernel) and
// qstem.cu: the requant epilogues, the mma.sync wrapper and the pot4
// decode, one code at a time (decode_pot) and four at a time from packed
// bytes (decode4_lo, decode4_hi).
//
// Each kernel's first template argument is a tag type named after the
// Python wrapper that launches it (the keys of kernels.launch_counts()), so
// a profiler trace names each launch by its wrapper.
//
// Accumulator range: |acc| <= 128 * max|w| * K (x may be -128). On the
// zoo's paths the largest pot4 K is 4608 (128 * 64 * 4608 = 3.8e7) and the
// largest int8 K the fc's 2048 (128 * 127 * 2048 = 3.3e7), both far below
// 2^31: int32 holds every sum exactly, in any order.
//
// Epilogue: acc * es and + eb are rounded as two separate f32 operations
// (__fmul_rn, __fadd_rn). A fused multiply-add would change the f32 value in
// about a quarter of the elements and break bit-exactness with the plain
// version. requant_resid (qmatmul_int8's residual, as the ViT's proj and
// mlp2) adds + f32(r) * radd as a third rounded step, r being the int8
// residual. Then relu, round half to even (rintf), clip to +-127.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf2 {
namespace {

__device__ __forceinline__ int8_t decode_pot(uint32_t c) {
  const int m = c & 7;
  const int mag = m ? (1 << (m - 1)) : 0;
  return (int8_t)((c & 8) ? -mag : mag);
}

__device__ __forceinline__ int8_t requant(int acc, float es, float eb, bool relu) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), es), eb);
  if (relu) v = fmaxf(v, 0.0f);
  v = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  return (int8_t)__float2int_rn(v);
}

// requant with the residual: ((acc * es) + eb) + r * radd, each rounded
__device__ __forceinline__ int8_t requant_resid(int acc, float es, float eb, int8_t r,
                                               float radd, bool relu) {
  float v = __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), es), eb),
                      __fmul_rn(__int2float_rn(r), radd));
  if (relu) v = fmaxf(v, 0.0f);
  v = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  return (int8_t)__float2int_rn(v);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 0xFF in each byte whose bit 7 is set, else 0 (prmt's sign-replicate
// selectors, which __byte_perm does not take)
__device__ __forceinline__ uint32_t byte_signs(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;\n" : "=r"(r) : "r"(x));
  return r;
}

// Four pot4 codes -> four int8 values (decode_pot's function, four at a
// time): m, the codes' low 3 bits, one in each byte; sign, 0xFF in the
// bytes whose code has bit 3 set. +2^(m-1) and -2^(m-1) come from two
// byte-permute tables (__byte_perm reads 3 bits of each selector nibble),
// picked per byte by the sign.
__device__ __forceinline__ uint32_t decode4(uint32_t m, uint32_t sign) {
  const uint32_t sel = __byte_perm(m | (m >> 4), 0, 0x20);  // nibbles m0 m1 m2 m3
  const uint32_t pos = __byte_perm(0x04020100u, 0x40201008u, sel);
  const uint32_t neg = __byte_perm(0xFCFEFF00u, 0xC0E0F0F8u, sel);
  return (pos & ~sign) | (neg & sign);
}

// The codes in the low and in the high nibbles of four packed bytes.
__device__ __forceinline__ uint32_t decode4_lo(uint32_t c) {
  return decode4(c & 0x07070707u, byte_signs(c << 4));
}
__device__ __forceinline__ uint32_t decode4_hi(uint32_t c) {
  return decode4((c >> 4) & 0x07070707u, byte_signs(c));
}

}  // namespace
}  // namespace tf2
