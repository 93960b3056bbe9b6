// Fused Adam for Hopper (sm_90a): one launch read-modify-writes the
// param, first and second moment of every leaf of a run.
//
// Replaces the Pallas TPU kernel `_adam_kernel`
// (deeplearning4j_tpu/kernels/fused_adam.py:78, driven by
// `adam_update_packed` -> pallas_call :249), which sweeps a packed run
// of identical layers raveled into one [rows, 128] buffer.
//
// Bound: about ten FLOPs per element against 28 bytes moved (p, g, m, v
// read and p, m, v written once, 4 bytes each in fp32), so device-memory
// bandwidth bounds it.
//
// Design (multi-tensor apply): the params stay in their layers' own
// tensors, so instead of the TPU kernel's concatenate-and-relayout the
// launch takes a table of up to kMaxLeaves (p, g, m, v) pointers with
// the prefix sums of their sizes, passed by value in the kernel's
// parameter space (__grid_constant__: read in place, no device copy of
// the table). A grid-stride loop walks the concatenated index space;
// each thread finds its leaf once by binary search and then only steps
// forward, and neighbouring threads touch neighbouring elements of one
// leaf. A run with more leaves takes one launch per kMaxLeaves.
//
// Rounding: the body is Adam.apply's expression tree, term for term,
// with each operation rounded on its own (__fmul_rn, __fadd_rn, ...):
// nvcc would otherwise contract a*b + c into an FMA, and the result
// would no longer be bit-equal to the plain per-op version (the JAX
// kernel pins the same thing with optimization_barrier). The scalars
// lr, 1-b1^t and 1-b2^t come in as float32 arguments, computed on the
// host as Adam.apply computes them. Grads may be fp32 or bf16 and are
// upcast to the fp32 param dtype on load.

#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kMaxLeaves = 96;
constexpr int NT = 256;

struct AdamTable {
  float* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long start[kMaxLeaves + 1];  // prefix sums of the leaf sizes
  int n_leaves;
};

struct AdamScalars {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps;
};

template <typename G>
__global__ void __launch_bounds__(NT)
    adam_kernel(const __grid_constant__ AdamTable tab,
                const __grid_constant__ AdamScalars s) {
  const long long total = tab.start[tab.n_leaves];
  const long long stride = (long long)gridDim.x * NT;
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= total) return;
  int lo = 0, hi = tab.n_leaves - 1;  // last leaf whose start <= i
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.start[mid] <= i) lo = mid; else hi = mid - 1;
  }
  int leaf = lo;
  for (; i < total; i += stride) {
    while (i >= tab.start[leaf + 1]) ++leaf;
    const long long j = i - tab.start[leaf];
    float* p = tab.p[leaf];
    float* m = tab.m[leaf];
    float* v = tab.v[leaf];
    const float g = Cvt<G>::to_f(((const G*)tab.g[leaf])[j]);
    const float m1 = __fadd_rn(__fmul_rn(s.b1, m[j]), __fmul_rn(s.omb1, g));
    const float v1 = __fadd_rn(__fmul_rn(s.b2, v[j]),
                               __fmul_rn(__fmul_rn(s.omb2, g), g));
    const float mhat = __fdiv_rn(m1, s.bc1);
    const float vhat = __fdiv_rn(v1, s.bc2);
    const float upd = __fdiv_rn(__fmul_rn(s.lr, mhat),
                                __fadd_rn(__fsqrt_rn(vhat), s.eps));
    p[j] = __fsub_rn(p[j], upd);
    m[j] = m1;
    v[j] = v1;
  }
}

}  // namespace
}  // namespace dl4j

// Updates `n` leaves in place: p/m/v are fp32, g fp32 (g_dtype 0) or
// bf16 (1), each leaf contiguous with sizes[i] > 0 elements. Launches
// ceil(n / 96) kernels on `stream` and returns the first non-zero
// cudaGetLastError(), or 0.
extern "C" int dl4j_fused_adam(int g_dtype, int n, void* const* p,
                               const void* const* g, void* const* m,
                               void* const* v, const long long* sizes,
                               float lr, float bc1, float bc2, float b1,
                               float omb1, float b2, float omb2, float eps,
                               int n_sm, void* stream) {
  if (g_dtype != dl4j::kF32 && g_dtype != dl4j::kBF16)
    return (int)cudaErrorInvalidValue;
  const dl4j::AdamScalars s{lr, bc1, bc2, b1, omb1, b2, omb2, eps};
  cudaStream_t st = (cudaStream_t)stream;
  for (int base = 0; base < n; base += dl4j::kMaxLeaves) {
    dl4j::AdamTable tab;
    tab.n_leaves = n - base < dl4j::kMaxLeaves ? n - base : dl4j::kMaxLeaves;
    tab.start[0] = 0;
    for (int i = 0; i < tab.n_leaves; ++i) {
      tab.p[i] = (float*)p[base + i];
      tab.g[i] = g[base + i];
      tab.m[i] = (float*)m[base + i];
      tab.v[i] = (float*)v[base + i];
      tab.start[i + 1] = tab.start[i] + sizes[base + i];
    }
    const long long total = tab.start[tab.n_leaves];
    if (total == 0) continue;
    long long blocks = (total + dl4j::NT - 1) / dl4j::NT;
    const long long cap = 8LL * (n_sm > 0 ? n_sm : 132);
    if (blocks > cap) blocks = cap;
    if (g_dtype == dl4j::kF32)
      dl4j::adam_kernel<float><<<(unsigned)blocks, dl4j::NT, 0, st>>>(tab, s);
    else
      dl4j::adam_kernel<__nv_bfloat16>
          <<<(unsigned)blocks, dl4j::NT, 0, st>>>(tab, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
