// LayerNorm and residual+LayerNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_ln_kernel` and `_residual_ln_kernel`
// (deeplearning4j_tpu/kernels/layernorm.py:55 and :67, driven by
// `layer_norm` / `residual_layer_norm`).
//
// Bound: device-memory bytes. About one FLOP per byte: each row is read
// once (x, plus h for the residual form) and written once (y, plus the
// sum s), with gamma/beta shared by every row. Design: one CUDA block per
// row; the row is staged in shared memory as fp32 while it is read, so
// the two-pass statistics (mean, then population variance) and the
// normalisation read shared memory, never device memory again. Block
// reductions are warp shuffles plus one word per warp in shared memory.
//
// Rounding follows the JAX kernel: statistics in fp32; the sum
// s = x + h rounded to x's dtype; the normalised value rounded to x's
// dtype, then `* gamma` and `+ beta` each rounded in that dtype.
// __fmul_rn/__fadd_rn keep nvcc from contracting them into one FMA, so
// the fp32 result matches the plain PyTorch version operation for
// operation.

#include "common.cuh"

namespace dl4j {
namespace {

// Sum of `v` over the block (blockDim.x a multiple of 32, <= 1024);
// every thread gets the total. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // earlier readers of red[0] are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < n_warps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

template <typename T, bool RESIDUAL>
__global__ void ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta, T* __restrict__ s,
                              T* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int D, float eps) {
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

template <typename T>
void launch(int residual, const void* x, const void* h, const void* g,
            const void* b, void* s, void* y, float* mean, float* rstd, int R,
            int D, float eps, cudaStream_t stream) {
  int threads = ((D + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (size_t)D * sizeof(float);
  if (residual) {
    ln_fwd_kernel<T, true><<<R, threads, smem, stream>>>(
        (const T*)x, (const T*)h, (const T*)g, (const T*)b, (T*)s, (T*)y,
        mean, rstd, D, eps);
  } else {
    ln_fwd_kernel<T, false><<<R, threads, smem, stream>>>(
        (const T*)x, nullptr, (const T*)g, (const T*)b, nullptr, (T*)y, mean,
        rstd, D, eps);
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
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == dl4j::kF32) {
    dl4j::launch<float>(residual, x, h, gamma, beta, s, y, mean, rstd, R, D,
                        eps, st);
  } else if (dtype == dl4j::kBF16) {
    dl4j::launch<__nv_bfloat16>(residual, x, h, gamma, beta, s, y, mean, rstd,
                                R, D, eps, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
