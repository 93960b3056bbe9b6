// Tensor-core and asynchronous-copy helpers for sm_90a (inline PTX):
// cp.async with zero fill, ldmatrix, mma.sync for bf16 (m16n8k16) and
// TF32 (m16n8k8), the hi + lo TF32 split of an fp32 value that 3xTF32
// products are built from (CUTLASS's OpMultiplyAddFastF32), the same
// split into two bf16 values, and ex2.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 /
// m16n8k8"), with g = lane / 4 and t = lane % 4:
//   C (16x8 fp32)   c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g+8
//   A bf16 (16x16)  a0a1 (g, 2t..), a2a3 (g+8, 2t..), a4a5 (g, 2t+8..),
//                   a6a7 (g+8, 2t+8..); two bf16 per 32-bit register
//   B bf16 (16x8)   b0b1 (k 2t.., n g), b2b3 (k 2t+8.., n g)
//   A tf32 (16x8)   a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B tf32 (8x8)    b0 (k t, n g), b1 (k t+4, n g)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that bypasses L1; writes zeros when !pred
// (src must still be a valid address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4-byte copy global -> shared; writes zeros when !pred
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and r[i] holds matrix i's (row l / 4, cols 2(l % 4), +1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, transposed: r[i] holds matrix i's (rows 2(l % 4), +1; col l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo both TF32
struct Tf32Pair {
  uint32_t hi, lo;
};
__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// c += a . b to about fp32 accuracy: lo.hi + hi.lo + hi.hi, small terms
// first (lo.lo is below fp32's rounding)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           Tf32Pair b0, Tf32Pair b1) {
  mma_tf32(c, a_lo, b0.hi, b1.hi);
  mma_tf32(c, a_hi, b0.lo, b1.lo);
  mma_tf32(c, a_hi, b0.hi, b1.hi);
}

// 2^x on the special-function unit (about 2 ulp; 2^-1e30 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 in one register, `lo` in the low half (the
// lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats x = hi + lo + O(2^-17 |x|), hi and lo both bf16, each pair
// packed as pack_bf16 packs it: two bf16 products, hi.b + lo.b, carry
// an fp32 operand to about 16 bits where one bf16 product carries 8
struct Bf16Pair {
  uint32_t hi, lo;
};
__device__ __forceinline__ Bf16Pair split_bf16(float c0, float c1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(c0, c1);
  const float2 hf = __bfloat1622float2(h);
  return {*reinterpret_cast<const uint32_t*>(&h),
          pack_bf16(c0 - hf.x, c1 - hf.y)};
}

}  // namespace dl4j
