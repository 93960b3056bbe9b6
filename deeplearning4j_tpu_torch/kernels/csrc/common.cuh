// Shared helpers for the hand-written Hopper kernels (plain C interface,
// loaded through ctypes; no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dl4j {

// dtype codes shared with deeplearning4j_tpu_torch/kernels/__init__.py
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// round a float to T's precision (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return Cvt<T>::to_f(Cvt<T>::from_f(v));
}

}  // namespace dl4j
