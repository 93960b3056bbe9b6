// LayerNorm and residual+LayerNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_ln_kernel` and `_residual_ln_kernel`
// (deeplearning4j_tpu/kernels/layernorm.py:55 and :67, driven by
// `layer_norm` / `residual_layer_norm`).
//
// Bound: device-memory bytes. About one FLOP per byte: each row is read
// once (x, plus h for the residual form) and written once (y, plus the
// sum s), with gamma/beta shared by every row. At [8192, 256] that is
// 16.8 MB in fp32 (5.0 us at 3.35 TB/s), half in bf16.
//
// Design, chosen by the row width D:
// - D <= 1024 (every LM width): a warp owns a row, and the row stays in
//   its registers, D / 32 values a lane. Where D and every pointer allow
//   it (D a multiple of 16 bytes' worth of elements, 16-byte aligned
//   rows), a lane moves 16 bytes at a time (4 fp32 or 8 bf16: lane l
//   takes chunks l, l + 32, ... of the row, so a warp reads 512
//   contiguous bytes an access); on a ragged width a lane takes elements
//   l, l + 32, ... one at a time. Mean and variance are warp shuffles: no
//   shared memory and no __syncthreads. A block holds 8 warps; the grid
//   is capped at 8 blocks an SM and its warps stride over the rows, so a
//   lane reads gamma and beta once and reuses them for every row its
//   warp takes. The per-lane item count is a template parameter (powers
//   of two), so the row's registers are sized at compile time.
// - 1024 < D <= 12288 (`MAX_D`): one block per row, the row staged once
//   in shared memory as fp32 while it is read, block reductions as warp
//   shuffles plus one word per warp in shared memory.
//
// Rounding follows the JAX kernel: statistics in fp32 (two passes: mean,
// then population variance); the sum s = x + h rounded to x's dtype; the
// normalised value rounded to x's dtype, then `* gamma` and `+ beta` each
// rounded in that dtype. __fmul_rn/__fadd_rn keep nvcc from contracting
// them into one FMA, so the fp32 result matches the plain PyTorch version
// operation for operation (the statistics' sums run in another order).

#include <stdint.h>

#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kWarpRowMaxD = 1024;  // widest row a warp keeps in registers
constexpr int kRowWarps = 8;        // warps (rows in flight) a block
constexpr int kBlocksPerSM = 8;     // 8 x 256 threads fill an SM

// W consecutive elements of T to or from fp32: one scalar access (W = 1)
// or one 16-byte vector access (W = 16 / sizeof(T)). Stores round to
// nearest.
template <typename T, int W>
struct Access;

template <typename T>
struct Access<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) {
    v[0] = Cvt<T>::to_f(*p);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    *p = Cvt<T>::from_f(v[0]);
  }
};

template <>
struct Access<float, 4> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Access<__nv_bfloat16, 8> {
  // a 32-bit word holds elements 2i (low half) and 2i + 1
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A warp per row. Lane `lane` owns the W-element groups starting at
// (lane + 32 j) W for j < J, those below D (D is a multiple of W).
template <typename T, bool RESIDUAL, int W, int J>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_warp_kernel(const T* __restrict__ x, const T* __restrict__ h,
                   const T* __restrict__ gamma, const T* __restrict__ beta,
                   T* __restrict__ s, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int R, int D, float eps) {
  using A = Access<T, W>;
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kRowWarps;
  float gm[J][W], bt[J][W];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (lane + 32 * j) * W;
    if (c < D) {
      A::load(gamma + c, gm[j]);
      A::load(beta + c, bt[j]);
    }
  }
  for (int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5); row < R;
       row += n_warps) {
    const long long off = (long long)row * D;
    float v[J][W];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (lane + 32 * j) * W;
      if (c >= D) continue;
      A::load(x + off + c, v[j]);
      if (RESIDUAL) {
        float hv[W];
        A::load(h + off + c, hv);
#pragma unroll
        for (int w = 0; w < W; ++w) v[j][w] = round_to<T>(__fadd_rn(v[j][w], hv[w]));
        A::store(s + off + c, v[j]);
      }
#pragma unroll
      for (int w = 0; w < W; ++w) sum += v[j][w];
    }
    const float mean = warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if ((lane + 32 * j) * W >= D) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float d = __fsub_rn(v[j][w], mean);
        sq += d * d;
      }
    }
    const float var = warp_sum(sq) / (float)D;
    const float rstd = 1.0f / sqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (lane + 32 * j) * W;
      if (c >= D) continue;
      float out[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float n = round_to<T>(__fmul_rn(__fsub_rn(v[j][w], mean), rstd));
        const float t = round_to<T>(__fmul_rn(n, gm[j][w]));
        out[w] = __fadd_rn(t, bt[j][w]);
      }
      A::store(y + off + c, out);
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// Sum of `v` over the block (blockDim.x a multiple of 32, <= 1024);
// every thread gets the total. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // earlier readers of red[0] are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float t = warp_sum(lane < n_warps ? red[lane] : 0.f);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// A block per row, for rows wider than a warp's registers.
template <typename T, bool RESIDUAL>
__global__ void ln_block_kernel(const T* __restrict__ x,
                                const T* __restrict__ h,
                                const T* __restrict__ gamma,
                                const T* __restrict__ beta,
                                T* __restrict__ s, T* __restrict__ y,
                                float* __restrict__ mean_out,
                                float* __restrict__ rstd_out, int D,
                                float eps) {
  extern __shared__ float row[];  // D floats: the row, read once
  __shared__ float red[32];
  const long long off = (long long)blockIdx.x * D;
  float acc = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float v = Cvt<T>::to_f(x[off + i]);
    if (RESIDUAL) {
      const T sv = Cvt<T>::from_f(__fadd_rn(v, Cvt<T>::to_f(h[off + i])));
      s[off + i] = sv;
      v = Cvt<T>::to_f(sv);
    }
    row[i] = v;
    acc += v;
  }
  const float mean = block_sum(acc, red) / (float)D;
  float acc2 = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = __fsub_rn(row[i], mean);
    acc2 += d * d;
  }
  const float var = block_sum(acc2, red) / (float)D;
  const float rstd = 1.0f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float n = round_to<T>(__fmul_rn(__fsub_rn(row[i], mean), rstd));
    const float t = round_to<T>(__fmul_rn(n, Cvt<T>::to_f(gamma[i])));
    y[off + i] = Cvt<T>::from_f(__fadd_rn(t, Cvt<T>::to_f(beta[i])));
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

struct LnArgs {
  const void *x, *h, *gamma, *beta;
  void *s, *y;
  float *mean, *rstd;
  int R, D;
  float eps;
  cudaStream_t stream;
};

int sm_count() {
  static int n = 0;  // one query a process
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, bool RES, int W, int J>
void launch_warp(const LnArgs& a) {
  const int want = (a.R + kRowWarps - 1) / kRowWarps;
  const int cap = sm_count() * kBlocksPerSM;
  ln_warp_kernel<T, RES, W, J><<<want < cap ? want : cap, 32 * kRowWarps, 0,
                                 a.stream>>>(
      (const T*)a.x, (const T*)a.h, (const T*)a.gamma, (const T*)a.beta,
      (T*)a.s, (T*)a.y, a.mean, a.rstd, a.R, a.D, a.eps);
}

// J = the smallest power of two >= `items` (a lane's groups), up to MAX_J
template <typename T, bool RES, int W, int J, int MAX_J>
void by_items(int items, const LnArgs& a) {
  if constexpr (J < MAX_J) {
    if (items > J) return by_items<T, RES, W, 2 * J, MAX_J>(items, a);
  }
  launch_warp<T, RES, W, J>(a);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T, bool RES>
void launch(const LnArgs& a) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (a.D > kWarpRowMaxD) {
    int threads = a.D < 1024 ? ((a.D + 31) / 32) * 32 : 1024;
    ln_block_kernel<T, RES><<<a.R, threads, (size_t)a.D * sizeof(float),
                              a.stream>>>(
        (const T*)a.x, (const T*)a.h, (const T*)a.gamma, (const T*)a.beta,
        (T*)a.s, (T*)a.y, a.mean, a.rstd, a.D, a.eps);
    return;
  }
  const bool vec = a.D % VEC == 0 && aligned16(a.x) && aligned16(a.y) &&
                   aligned16(a.gamma) && aligned16(a.beta) &&
                   (!RES || (aligned16(a.h) && aligned16(a.s)));
  if (vec) {
    by_items<T, RES, VEC, 1, kWarpRowMaxD / 32 / VEC>(
        (a.D / VEC + 31) / 32, a);
  } else {
    by_items<T, RES, 1, 1, kWarpRowMaxD / 32>((a.D + 31) / 32, a);
  }
}

}  // namespace
}  // namespace dl4j

// x, h, s, y: [R, D] contiguous in `dtype`; gamma, beta: [D] in `dtype`;
// mean, rstd: [R] fp32. `h` and `s` are read/written only when
// `residual` is nonzero. Returns cudaGetLastError() after the launch.
extern "C" int dl4j_layer_norm_fwd(int dtype, int residual, const void* x,
                                   const void* h, const void* gamma,
                                   const void* beta, void* s, void* y,
                                   float* mean, float* rstd, int R, int D,
                                   float eps, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  const dl4j::LnArgs a{x, h, gamma, beta, s, y, mean, rstd, R, D, eps,
                       (cudaStream_t)stream};
  if (dtype == dl4j::kF32) {
    residual ? dl4j::launch<float, true>(a) : dl4j::launch<float, false>(a);
  } else if (dtype == dl4j::kBF16) {
    residual ? dl4j::launch<__nv_bfloat16, true>(a)
             : dl4j::launch<__nv_bfloat16, false>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
