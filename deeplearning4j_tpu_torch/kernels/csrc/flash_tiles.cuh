// The tiles the flash kernels share (csrc/flash_attention.cu, the
// forward; csrc/flash_attention_bwd.cu, the backward): 4 warps a block,
// each owning 16 rows of the block's 64-row tile; [rows][D] tiles staged
// through cp.async with 16-byte padded rows; and one warp's tensor-core
// products on them. The fragment layouts are in mma.cuh.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace dl4j {

constexpr int NW = 4;        // warps a block
constexpr int NT = 32 * NW;  // threads a block
constexpr int BM = 16 * NW;  // rows of the block's own tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// rows of the streamed tile
template <int D>
__host__ __device__ constexpr int stream_rows() {
  return D == 128 ? 32 : 64;
}

// pitch (elements) of a staged [rows][D] tile: 16 bytes of padding
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / (int)sizeof(T);
}

// stage rows [t0, t0 + ROWS) of one (batch, head) of `src` (row stride
// `st`) into dst [ROWS][pitch] through cp.async; rows past `len` are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long st,
                                          int t0, int len) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks a row
  constexpr int P = pitch<T, D>();
  static_assert(ROWS * CPR % NT == 0, "whole chunks for every thread");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / CPR, c = i % CPR, t = t0 + r;
    const bool ok = t < len;
    cp_async_16(dst + r * P + c * EPC, ok ? src + t * st + c * EPC : src, ok);
  }
}

// cp.async moves 16 bytes at a time: every row start of a [B, T, H, D]
// tensor must be 16-byte aligned, so its pointer and its {b, t, h}
// strides (elements of `elem` bytes) in bytes
inline bool rows_aligned16(const void* p, const long long* strides,
                           int elem) {
  if ((uintptr_t)p % 16) return false;
  for (int j = 0; j < 3; ++j)
    if (strides[j] * elem % 16) return false;
  return true;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One warp's products. `A` points at the warp's first row of a staged
// tile, `B` at a staged tile; both [rows][P] in shared memory.
//   abt: acc[N/8][4] += A[16 x D] . B[N x D]^T  (S, dP and their transposes)
//   xb:  acc[D/8][4] += X[16 x N] . B[N x D]    (X = P or dS, in the
//        accumulator layout abt leaves it in)
template <typename T>
struct WarpMma;

template <>
struct WarpMma<__nv_bfloat16> {
  using T = __nv_bfloat16;

  template <int D, int N, int P>
  static __device__ __forceinline__ void abt(float (&acc)[N / 8][4],
                                             const T* A, const T* B,
                                             int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, A + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
        // (n 8-15, k 8-15) of this 16 x 16 block of B
        uint32_t b[4];
        ldmatrix_x4(b, B + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  template <int D, int N, int P>
  static __device__ __forceinline__ void xb(float (&acc)[D / 8][4],
                                            const float (&x)[N / 8][4],
                                            const T* B, int lane) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                             pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                             pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                             pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // transposed matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
        // (k 0-7, n 8-15), (k 8-15, n 8-15) of B [k][n]
        uint32_t b[4];
        ldmatrix_x4_trans(b, B + (kk * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * P +
                                 dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
};

template <>
struct WarpMma<float> {
  template <int D, int N, int P>
  static __device__ __forceinline__ void abt(float (&acc)[N / 8][4],
                                             const float* A, const float* B,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* ap = A + g * P + kk * 8 + t;
      const Tf32Pair a0 = split_tf32(ap[0]), a1 = split_tf32(ap[8 * P]),
                     a2 = split_tf32(ap[4]), a3 = split_tf32(ap[8 * P + 4]);
      const uint32_t hi[4] = {a0.hi, a1.hi, a2.hi, a3.hi};
      const uint32_t lo[4] = {a0.lo, a1.lo, a2.lo, a3.lo};
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        const float* bp = B + (n * 8 + g) * P + kk * 8 + t;
        mma_3xtf32(acc[n], hi, lo, split_tf32(bp[0]), split_tf32(bp[4]));
      }
    }
  }

  // The tensor cores round their fp32 sums toward zero, so a sum chained
  // over every streamed tile would drift by up to an ulp a step. Each
  // tile's sum starts from zero instead, C 8-column tiles at a time, and
  // is added to acc with an ordinary (round-to-nearest) fp32 add.
  template <int D, int N, int P>
  static __device__ __forceinline__ void xb(float (&acc)[D / 8][4],
                                            const float (&x)[N / 8][4],
                                            const float* B, int lane) {
    const int g = lane >> 2, t = lane & 3;
    constexpr int C = D == 128 ? 2 : 4;
#pragma unroll
    for (int c0 = 0; c0 < D / 8; c0 += C) {
      float part[C][4];
#pragma unroll
      for (int dn = 0; dn < C; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[dn][e] = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        // x's columns 2t, 2t+1 of tile j enter as k = t, t + 4
        const Tf32Pair a0 = split_tf32(x[j][0]), a1 = split_tf32(x[j][2]),
                       a2 = split_tf32(x[j][1]), a3 = split_tf32(x[j][3]);
        const uint32_t hi[4] = {a0.hi, a1.hi, a2.hi, a3.hi};
        const uint32_t lo[4] = {a0.lo, a1.lo, a2.lo, a3.lo};
#pragma unroll
        for (int dn = 0; dn < C; ++dn) {
          const float* bp = B + (j * 8 + 2 * t) * P + (c0 + dn) * 8 + g;
          mma_3xtf32(part[dn], hi, lo, split_tf32(bp[0]),
                     split_tf32(bp[P]));
        }
      }
#pragma unroll
      for (int dn = 0; dn < C; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c0 + dn][e] += part[dn][e];
    }
  }
};

}  // namespace dl4j
