// Threefry-2x32 random words and fused inverted dropout for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package draws its dropout and
// weight-noise masks with `jax.random.bernoulli` / `jax.random.normal`
// (deeplearning4j_tpu/nn/conf/dropout.py:63, nn/layers/base.py:199,
// nn/layers/attention.py:389, nn/conf/weightnoise.py:86), which XLA
// fuses into the consumer. The port reproduces those bits exactly
// (deeplearning4j_tpu_torch/common/prng.py): element n of a draw hashes
// the 64-bit flat index, split into the words (n >> 32, n & 0xFFFFFFFF),
// under the draw's key with the 20-round Threefry-2x32 of JAX's lowering
// (`_threefry2x32_lowering`), and its word is y0 ^ y1.
//
// Bound: integer operations. A word costs about 80 of them (20 rounds of
// add, rotate, xor; 5 key injections; the index split), against 8 bytes
// moved per fp32 element of dropout (x read, y written): at 16.7 T
// int32 operations a second (64 lanes an SM, 132 SMs, 1.98 GHz) that is
// about 5 ns per thousand elements against 2.4 ns for the bytes at
// 3.35 TB/s. The rotations compile to one funnel shift each.
//
// `dl4j_threefry_bits_rows` is the same hash with a key per row: row s of
// an [S, n] draw under key s (one launch draws every serving slot's
// Gumbel noise, each under its own request's key). The same bound holds
// per word; the [S, 2] keys add 8 bytes a row.
//
// Design: a grid-stride loop, one element an iteration, neighbouring
// threads on neighbouring elements (coalesced loads and stores of any
// alignment, so offset views and ragged lengths need no special path).
// Indices are 64-bit: a draw may exceed 2^32 elements' offsets. The grid
// is capped at 16 blocks an SM; each thread derives its own word, so no
// state is shared and nothing is saved for the backward: the backward
// of dropout is dropout of the gradient under the same key, which
// recomputes the same mask (no uint8 mask in device memory).
//
// `dl4j_dropout` compares uniform < p in fp32 exactly as JAX does
// (uniform = float((w >> 9) | 0x3F800000) - 1) and writes x / p_dt or 0,
// where p_dt is p rounded to x's dtype (JAX's `x / jnp.asarray(p,
// x.dtype)`); the quotient is computed in fp32 with __fdiv_rn and rounded
// once to x's dtype, as PyTorch's bf16 division does.

#include <stdint.h>

#include "common.cuh"

namespace dl4j {
namespace {

constexpr int NT = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int a,
                                       int b, int c, int d) {
  x0 += x1; x1 = rotl(x1, a); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, b); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, c); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
}

// The word of flat index n under key (k0, k1): y0 ^ y1 of
// threefry2x32((k0, k1), (n >> 32, n & 0xFFFFFFFF)).
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  unsigned long long n) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(n >> 32) + k0;
  uint32_t x1 = (uint32_t)n + k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__global__ void __launch_bounds__(NT)
    bits_kernel(uint32_t k0, uint32_t k1, unsigned long long offset,
                long long n, uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    out[i] = threefry_word(k0, k1, offset + (unsigned long long)i);
}

// Row s of [S, n] under key s: keys holds S (k0, k1) pairs.
__global__ void __launch_bounds__(NT)
    rows_kernel(const uint32_t* __restrict__ keys, long long n,
                long long total, uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += stride) {
    const long long s = i / n;
    out[i] = threefry_word(keys[2 * s], keys[2 * s + 1],
                           (unsigned long long)(i - s * n));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t k0, uint32_t k1, float p, float p_dt) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const uint32_t w = threefry_word(k0, k1, (unsigned long long)i);
    const float u = __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
    const float xv = Cvt<T>::to_f(x[i]);
    y[i] = Cvt<T>::from_f(u < p ? __fdiv_rn(xv, p_dt) : 0.0f);
  }
}

unsigned grid_for(long long n, int n_sm) {
  long long blocks = (n + NT - 1) / NT;
  const long long cap = 16LL * (n_sm > 0 ? n_sm : 132);
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace
}  // namespace dl4j

// The words of flat indices [offset, offset + n) under key (k0, k1) into
// out[0, n) (uint32). Returns cudaGetLastError() after the launch.
extern "C" int dl4j_threefry_bits(unsigned k0, unsigned k1,
                                  unsigned long long offset, long long n,
                                  void* out, int n_sm, void* stream) {
  if (n <= 0) return 0;
  dl4j::bits_kernel<<<dl4j::grid_for(n, n_sm), dl4j::NT, 0,
                      (cudaStream_t)stream>>>(k0, k1, offset, n,
                                              (uint32_t*)out);
  return (int)cudaGetLastError();
}

// Per-row keys: out[s * n + j] is the word of flat index j under key
// (keys[2s], keys[2s + 1]), for s in [0, S) and j in [0, n) — JAX's
// `vmap` of a draw over a batch of keys (the serving sampler's noise for
// every slot, each slot under its own request's key, in one launch).
// Returns cudaGetLastError() after the launch.
extern "C" int dl4j_threefry_bits_rows(const void* keys, long long S,
                                       long long n, void* out, int n_sm,
                                       void* stream) {
  if (S <= 0 || n <= 0) return 0;
  const long long total = S * n;
  dl4j::rows_kernel<<<dl4j::grid_for(total, n_sm), dl4j::NT, 0,
                      (cudaStream_t)stream>>>((const uint32_t*)keys, n, total,
                                              (uint32_t*)out);
  return (int)cudaGetLastError();
}

// y[i] = x[i] / p_dt where uniform(word(i)) < p, else 0, for i in
// [0, n); x and y contiguous of dtype 0 (fp32) or 1 (bf16); p_dt is p
// rounded to that dtype. Returns cudaGetLastError() after the launch.
extern "C" int dl4j_dropout(int dtype, const void* x, void* y, long long n,
                            unsigned k0, unsigned k1, float p, float p_dt,
                            int n_sm, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = dl4j::grid_for(n, n_sm);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == dl4j::kF32)
    dl4j::dropout_kernel<float><<<grid, dl4j::NT, 0, st>>>(
        (const float*)x, (float*)y, n, k0, k1, p, p_dt);
  else if (dtype == dl4j::kBF16)
    dl4j::dropout_kernel<__nv_bfloat16><<<grid, dl4j::NT, 0, st>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, k0, k1, p, p_dt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
