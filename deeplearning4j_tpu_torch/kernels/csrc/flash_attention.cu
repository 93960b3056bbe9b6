// Flash-attention forward for Hopper (sm_90a), in its two modes.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:87, through
// `_fwd_pallas_call`):
// - finalize (`flash_attention` -> `_flash_forward`): per (batch, head),
//   o = softmax(q k^T / sqrt(D)) v with the online (streaming) softmax in
//   fp32, the causal mask k_pos <= q_pos and the ragged key tail masked
//   with -1e30 (the JAX kernel's value), and lse = m + log(l). Emits
//   o [B, Tq, H, D] in the input dtype and lse [B, H, Tq] in fp32.
// - carry (`flash_attention_carry`, carry=True, finalize=False): the
//   ring-attention fold. The running state is seeded from m, l [B, H, Tq]
//   and the unnormalised acc [B, H, Tq, D] (all fp32), one K/V chunk is
//   folded in with the same online softmax (`diag` is the causal mask
//   between local positions), and (m, l, acc) is written back IN PLACE:
//   each block reads its own rows before the first __syncthreads of the
//   k loop and writes them after the last, and no other block touches
//   them. A first fold from m = -1e30 gives corr = exp(-1e30 - m_new)
//   = 0, as in JAX; -inf must never be fed in (-inf - -inf is NaN).
//   Tq may differ from Tk when not `diag`.
//
// Bound: at the slice's shapes (T = 512, D = 32..128) the work is
// 4 * D FLOPs per visible (q, k) pair against 4 reads/writes of a
// [B, T, H, D] tensor, so the arithmetic bounds it. This first kernel
// runs that arithmetic on the fp32 CUDA cores (no mma/wgmma yet) and
// keeps the [T, T] scores out of device memory: each CUDA block owns one
// (batch, head, 64-row q tile), holds Q, the current 64-row K/V tile and
// the 64x64 probability tile in shared memory, and carries the running
// (m, l, acc) in registers. The TPU's sequential k grid dimension
// becomes the loop inside the block; causal tiles wholly above the
// diagonal are skipped. q/k/v are read through their [B, T, H, D]
// strides (the last dim contiguous), with no transpose copy. The carry
// mode is the same kernel (template flag CARRY): only the state's seed
// and its write-back differ, so its bound and design are the same; it
// adds a read and a write of the fp32 state, 8 (D + 2) bytes per row.
//
// Thread layout (256 threads): thread (ty, tx) = (tid / 16, tid % 16)
// owns q rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
// output columns tx + 16 c (c < D / 16). A row's 16 owners are 16
// adjacent lanes of one warp, so row max/sum are 4 xor-shuffles. K rows
// are padded to D + 1 floats so the 16 lanes reading 16 K rows at one d
// hit 16 banks.

#include "common.cuh"

namespace dl4j {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1));
}

// Strides (in elements) of q [B, Tq, H, D], k and v [B, Tk, H, D]: batch,
// time, head for each; the D axis is contiguous.
struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

// Finalize: o, lse are written, the state pointers are unused. Carry:
// st_m, st_l [B, H, Tq] and st_acc [B, H, Tq, D] (contiguous fp32) are
// read as the seed and overwritten with the folded state; o, lse unused.
template <typename T, int D, bool CAUSAL, bool CARRY>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, float* st_m, float* st_l,
                     float* st_acc, int H, int Tq, int Tk, Strides sd,
                     float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D]   q * scale, fp32
  float* Ks = Qs + BQ * D;          // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK+1] probabilities

  constexpr int RPT = BQ / 16;  // q rows per thread
  constexpr int CPT = BK / 16;  // score columns per thread
  constexpr int DPT = D / 16;   // output columns per thread

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qp = q + bb * sd.qb + hh * sd.qh;
  const T* kp = k + bb * sd.kb + hh * sd.kh;
  const T* vp = v + bb * sd.vb + hh * sd.vh;
  // row (b, h, t) of the [B, H, Tq] state / lse layout is row0 + t
  const long long row0 = ((long long)bb * H + hh) * Tq;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = q0 + r;
    Qs[idx] = t < Tq ? __fmul_rn(Cvt<T>::to_f(qp[t * sd.qt + d]), scale) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = q0 + ty + 16 * i;
    if (CARRY && t < Tq) {
      m[i] = st_m[row0 + t];
      l[i] = st_l[row0 + t];
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        acc[i][c] = st_acc[(row0 + t) * D + tx + 16 * c];
    } else {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
    }
  }

  int n_k = (Tk + BK - 1) / BK;
  if (CAUSAL) {
    const int last = (q0 + BQ - 1) / BK;  // tiles past the diagonal skip
    n_k = n_k < last + 1 ? n_k : last + 1;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q staged; previous tile's K/V/P reads finished
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D, t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < Tk) {
        kv = Cvt<T>::to_f(kp[t * sd.kt + d]);
        vv = Cvt<T>::to_f(vp[t * sd.vt + d]);
      }
      Ks[r * (D + 1) + d] = kv;
      Vs[idx] = vv;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < Tk && (!CAUSAL || kpos <= qpos);
        if (!valid) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    if (CARRY) {
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        st_acc[(row0 + t) * D + tx + 16 * c] = acc[i][c];
      if (tx == 0) {
        st_m[row0 + t] = m[i];
        st_l[row0 + t] = l[i];
      }
      continue;
    }
    const float ls = fmaxf(l[i], 1e-20f);
    T* orow = o + (((long long)bb * Tq + t) * H + hh) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      orow[tx + 16 * c] = Cvt<T>::from_f(acc[i][c] / ls);
    if (tx == 0) lse[row0 + t] = m[i] + logf(ls);
  }
}

// What one launch needs, passed down the dispatch by reference.
struct Launch {
  const void *q, *k, *v;
  void* o;
  float *lse, *m, *l, *acc;
  int B, Tq, Tk, H;
  Strides sd;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool CAUSAL, bool CARRY>
int launch(const Launch& a) {
  auto kern = flash_fwd_kernel<T, D, CAUSAL, CARRY>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lse, a.m, a.l,
      a.acc, a.H, a.Tq, a.Tk, a.sd, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool CARRY>
int dispatch_causal(int causal, const Launch& a) {
  return causal ? launch<T, D, true, CARRY>(a) : launch<T, D, false, CARRY>(a);
}

template <typename T, bool CARRY>
int dispatch_d(int D, int causal, const Launch& a) {
  switch (D) {
    case 32:
      return dispatch_causal<T, 32, CARRY>(causal, a);
    case 64:
      return dispatch_causal<T, 64, CARRY>(causal, a);
    case 128:
      return dispatch_causal<T, 128, CARRY>(causal, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool CARRY>
int dispatch(int dtype, int D, int causal, const Launch& a) {
  if (a.B <= 0 || a.Tq <= 0 || a.H <= 0) return 0;
  if (a.Tk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return dispatch_d<float, CARRY>(D, causal, a);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16, CARRY>(D, causal, a);
  return (int)cudaErrorInvalidValue;
}

Strides strides_of(const long long* st) {
  return Strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
}

}  // namespace
}  // namespace dl4j

// q [B, Tq, H, D], k/v [B, Tk, H, D] in `dtype`, addressed through their
// batch/time/head strides (in elements; the D axis contiguous). o is a
// contiguous [B, Tq, H, D] in `dtype`, lse a contiguous [B, H, Tq] fp32.
// strides = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh}. D must be 32,
// 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int dl4j_flash_attention_fwd(int dtype, int causal, const void* q,
                                        const void* k, const void* v, void* o,
                                        float* lse, int B, int Tq, int Tk,
                                        int H, int D, const long long* strides,
                                        float scale, void* stream) {
  dl4j::Launch a{q,  k,  v,  o,  lse, nullptr, nullptr, nullptr,
                 B,  Tq, Tk, H,  dl4j::strides_of(strides), scale,
                 (cudaStream_t)stream};
  return dl4j::dispatch<false>(dtype, D, causal, a);
}

// The carry fold: q, k, v as above; m, l a contiguous [B, H, Tq] fp32 and
// acc a contiguous [B, H, Tq, D] fp32 hold the running state and are
// updated IN PLACE. `diag` masks k_pos > q_pos between local positions
// (the caller guarantees Tq == Tk then). Returns cudaGetLastError().
extern "C" int dl4j_flash_attention_carry(int dtype, int diag, const void* q,
                                          const void* k, const void* v,
                                          float* m, float* l, float* acc,
                                          int B, int Tq, int Tk, int H, int D,
                                          const long long* strides,
                                          float scale, void* stream) {
  dl4j::Launch a{q,  k,  v,  nullptr, nullptr, m, l, acc,
                 B,  Tq, Tk, H,       dl4j::strides_of(strides), scale,
                 (cudaStream_t)stream};
  return dl4j::dispatch<true>(dtype, D, diag, a);
}
