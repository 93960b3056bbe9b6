// Viterbi max-product decode for Hopper (sm_90a): the forward recursion
// over T steps and the backtrace of one HMM decode in one launch.
//
// Replaces no Pallas kernel: the JAX package runs `_viterbi_core`
// (deeplearning4j_tpu/util/viterbi.py:27-53) as one XLA program, a
// `lax.scan` over T of the [S]-vector recursion and a reverse scan for
// the backtrace. Written as PyTorch ops, each of the T steps would take
// about five launches (over 300,000 for a 65,536-step decode), so the
// scan is a kernel.
//
// Numerics: every step is ``scores[i, j] = prev[i] + log_trans[i, j]``,
// ``best[j] = max_i scores[i, j]``, ``cur[j] = best[j] + log_emit[t, j]``:
// two fp32 adds and a compare, no product, so nothing can contract into
// an FMA and the kernel's path and score equal the plain version's (and
// XLA's) bit for bit. The argmax scans i in ascending order and takes a
// value only when it is strictly greater: `jnp.argmax`'s first-index rule
// on ties, and index 0 when every value is -inf.
//
// Bound: operations. A decode does 2 (T - 1) S^2 fp32 adds and compares
// against 4 (T S + S^2 + T) bytes of inputs and outputs: at T = 65,536,
// S = 77 that is 777 M operations (0.0116 ms at 67 TFLOP/s, the card's
// fp32 rate outside the tensor cores) against 20 MB (0.0062 ms at
// 3.35 TB/s). The critical path is T dependent steps, each a scan of S
// values, so a decode sits far above that bound.
//
// Design: one block per decode. Thread j keeps state j (strided when
// S > 1024) and holds `prev` and `cur` in shared memory, with one
// __syncthreads a step; `log_trans` is staged in shared memory when it
// fits (S <= 200), else read through L2. Each step writes its int32
// backpointers [S] to device memory (the wrapper's scratch). After the
// last step thread 0 takes the score and the end state (the same
// first-index rule) and walks the backpointers to the path.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemTransMax = 200;   // S^2 fp32 in shared memory: 160 KB

template <bool SMEM_TRANS>
__global__ void __launch_bounds__(kMaxThreads)
    viterbi_kernel(const float* __restrict__ em,
                   const float* __restrict__ trans,
                   const float* __restrict__ prior, int T, int S,
                   int* __restrict__ back, int* __restrict__ path,
                   float* __restrict__ score) {
  extern __shared__ float smem[];
  float* prev = smem;
  float* cur = smem + S;
  const float* tr = trans;
  if (SMEM_TRANS) {
    float* st = smem + 2 * S;
    for (int k = threadIdx.x; k < S * S; k += blockDim.x) st[k] = trans[k];
    tr = st;
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    prev[j] = __fadd_rn(prior[j], em[j]);
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* e = em + (long long)t * S;
    int* bp = back + (long long)(t - 1) * S;
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      const float ej = e[j];
      float best = -INFINITY;
      int arg = 0;
      for (int i = 0; i < S; ++i) {
        const float v = __fadd_rn(prev[i], tr[(long long)i * S + j]);
        if (v > best) {
          best = v;
          arg = i;
        }
      }
      bp[j] = arg;
      cur[j] = __fadd_rn(best, ej);
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  if (threadIdx.x == 0) {
    float best = -INFINITY;
    int s = 0;
    for (int j = 0; j < S; ++j) {
      if (prev[j] > best) {
        best = prev[j];
        s = j;
      }
    }
    *score = best;
    path[T - 1] = s;
    for (int t = T - 1; t >= 1; --t) {
      s = back[(long long)(t - 1) * S + s];
      path[t - 1] = s;
    }
  }
}

template <bool SMEM_TRANS>
int launch(const float* em, const float* trans, const float* prior, int T,
           int S, int* back, int* path, float* score, cudaStream_t stream) {
  auto kern = viterbi_kernel<SMEM_TRANS>;
  const size_t smem =
      sizeof(float) * (2 * (size_t)S + (SMEM_TRANS ? (size_t)S * S : 0));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((S + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kern<<<1, threads, smem, stream>>>(em, trans, prior, T, S, back, path,
                                     score);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// One decode: em [T, S], trans [S, S] (row = from), prior [S], all fp32
// and contiguous; back is int32 scratch of max(T - 1, 1) x S; writes
// path [T] (int32) and score [1] (fp32). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for T < 1 or S < 1).
extern "C" int dl4j_viterbi(const void* em, const void* trans,
                            const void* prior, int T, int S, void* back,
                            void* path, void* score, void* stream) {
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= dl4j::kSmemTransMax)
    return dl4j::launch<true>((const float*)em, (const float*)trans,
                              (const float*)prior, T, S, (int*)back,
                              (int*)path, (float*)score, st);
  return dl4j::launch<false>((const float*)em, (const float*)trans,
                             (const float*)prior, T, S, (int*)back,
                             (int*)path, (float*)score, st);
}
