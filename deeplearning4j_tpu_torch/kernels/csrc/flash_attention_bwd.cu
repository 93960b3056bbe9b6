// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:265, driven by
// `_bwd_dq_chunk` -> pallas_call :396) and `_flash_bwd_dkv_kernel`
// (:307, driven by `_bwd_dkv_chunk` -> pallas_call :434).
//
// Both recompute the probabilities from the forward's lse instead of
// storing the [T, T] matrix:
//   s  = (q . k) * scale, masked with -1e30 (the JAX value, not -inf)
//   p  = exp(s - lse)
//   dp = dO . v,  ds = p * (dp - delta),  delta = rowsum(dO * O)
//   dQ = scale * sum_k ds k,   dV = sum_q p^T dO,   dK = scale * sum_q ds^T q
// Keys past Tk are masked in dQ, query rows past Tq in dK/dV, and with
// causal masking k_pos <= q_pos; tiles wholly on the masked side of the
// diagonal are skipped, as the Pallas kernels skip them.
//
// Bound: per visible (q, k) pair dQ does 6 * D FLOPs (s, dp, dq) and
// dK/dV 8 * D (s, dp, dv, dk) against a handful of [B, T, H, D] reads
// and writes, so at T = 512 the arithmetic bounds both. Like the
// forward, these first kernels run it on the fp32 CUDA cores (no
// mma/wgmma yet), with the fp32 sums in registers.
//
// Design: the TPU's sequential minor grid dimension becomes a loop
// inside the block, and the split of the JAX package is kept, so no
// block writes what another writes: no atomics, and results do not
// depend on scheduling.
//   dQ: one block per (batch, head, 64-row q tile). Q and dO stay in
//       shared memory; the block walks the 64-row K/V tiles, builds the
//       64x64 dS tile in shared memory and accumulates dQ in registers.
//   dK/dV: one block per (batch, head, 64-row k tile). K and V stay in
//       shared memory; the block walks the q tiles, builds P^T and dS^T
//       tiles and accumulates dK and dV in registers.
// 256 threads as (ty, tx) = (tid / 16, tid % 16): a thread owns tile
// rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and feature
// columns tx + 16 c (c < D / 16). Every staged row is padded to D + 1
// (or 65) floats so the 16 lanes that read 16 rows at one column hit 16
// banks. Tensors are read through their [B, T, H, D] strides (D
// contiguous); outputs are contiguous [B, T, H, D] in the input dtype.

#include "common.cuh"

namespace dl4j {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int R = 4;  // tile rows (and score columns) per thread
constexpr float kNegInf = -1e30f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dq;
  void* dk;
  void* dv;
  int H, Tq, Tk;
  // element strides {b, t, h} of q, k, v, dout
  long long sq[3], sk[3], sv[3], sd[3];
  float scale;
};

// stage rows [t0, t0 + 64) of one (batch, head) of `src` as fp32 into a
// [64][D + 1] tile, zeros past `len`
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int t0, int len) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = t0 + r;
    dst[r * (D + 1) + d] = t < len ? Cvt<T>::to_f(src[t * st + d]) : 0.f;
  }
}

// ------------------------------------------------------------------ dQ
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * (size_t)64 * (D + 1) + (size_t)BQ * (BK + 1));
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D+1]
  float* dOs = Qs + BQ * (D + 1);  // [BQ][D+1]
  float* Ks = dOs + BQ * (D + 1);  // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);   // [BK][D+1]
  float* dSs = Vs + BK * (D + 1);  // [BQ][BK+1]
  constexpr int DPT = D / 16;

  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qp = (const T*)a.q + bb * a.sq[0] + hh * a.sq[2];
  const T* kp = (const T*)a.k + bb * a.sk[0] + hh * a.sk[2];
  const T* vp = (const T*)a.v + bb * a.sv[0] + hh * a.sv[2];
  const T* dp_ = (const T*)a.dout + bb * a.sd[0] + hh * a.sd[2];
  const long long row0 = ((long long)bb * a.H + hh) * a.Tq;

  stage<T, D>(Qs, qp, a.sq[1], q0, a.Tq);
  stage<T, D>(dOs, dp_, a.sd[1], q0, a.Tq);
  float lse[R], dlt[R], acc[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    lse[i] = t < a.Tq ? a.lse[row0 + t] : 0.f;
    dlt[i] = t < a.Tq ? a.delta[row0 + t] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  int n_k = (a.Tk + BK - 1) / BK;
  if (CAUSAL) {
    const int last = (q0 + BQ - 1) / BK;  // tiles past the diagonal skip
    n_k = n_k < last + 1 ? n_k : last + 1;
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q/dO staged; the previous tile's reads finished
    stage<T, D>(Ks, kp, a.sk[1], k0, a.Tk);
    stage<T, D>(Vs, vp, a.sv[1], k0, a.Tk);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        ov[i] = dOs[(ty + 16 * i) * (D + 1) + d];
        kv[i] = Ks[(tx + 16 * i) * (D + 1) + d];
        vv[i] = Vs[(tx + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < a.Tk && (!CAUSAL || kpos <= qpos);
        const float sc = valid ? s[i][j] * a.scale : kNegInf;
        const float p = expf(sc - lse[i]);
        dSs[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = Ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ds = dSs[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  T* dq = (T*)a.dq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= a.Tq) continue;
    T* row = dq + (((long long)bb * a.Tq + t) * a.H + hh) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      row[tx + 16 * c] = Cvt<T>::from_f(acc[i][c] * a.scale);
  }
}

// --------------------------------------------------------------- dK/dV
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * (size_t)64 * (D + 1) +
                          2 * (size_t)BK * (BQ + 1) + 2 * (size_t)BQ);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* Ks = smem;                // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);   // [BK][D+1]
  float* Qs = Vs + BK * (D + 1);   // [BQ][D+1]
  float* dOs = Qs + BQ * (D + 1);  // [BQ][D+1]
  float* Ps = dOs + BQ * (D + 1);  // [BK][BQ+1]  p^T
  float* dSs = Ps + BK * (BQ + 1); // [BK][BQ+1]  ds^T
  float* lse_s = dSs + BK * (BQ + 1);
  float* dlt_s = lse_s + BQ;
  constexpr int DPT = D / 16;

  const int k0 = blockIdx.x * BK, hh = blockIdx.y, bb = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qp = (const T*)a.q + bb * a.sq[0] + hh * a.sq[2];
  const T* kp = (const T*)a.k + bb * a.sk[0] + hh * a.sk[2];
  const T* vp = (const T*)a.v + bb * a.sv[0] + hh * a.sv[2];
  const T* dp_ = (const T*)a.dout + bb * a.sd[0] + hh * a.sd[2];
  const long long row0 = ((long long)bb * a.H + hh) * a.Tq;

  stage<T, D>(Ks, kp, a.sk[1], k0, a.Tk);
  stage<T, D>(Vs, vp, a.sv[1], k0, a.Tk);
  float dk[R][DPT], dv[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (a.Tq + BQ - 1) / BQ;
  // causal: q tiles whose last row lies before this k tile skip
  const int qt0 = CAUSAL ? k0 / BQ : 0;
  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // K/V staged; the previous tile's reads finished
    stage<T, D>(Qs, qp, a.sq[1], q0, a.Tq);
    stage<T, D>(dOs, dp_, a.sd[1], q0, a.Tq);
    if (threadIdx.x < BQ) {
      const int t = q0 + threadIdx.x;
      lse_s[threadIdx.x] = t < a.Tq ? a.lse[row0 + t] : 0.f;
      dlt_s[threadIdx.x] = t < a.Tq ? a.delta[row0 + t] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are keys (ty + 16 i), columns queries
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[R], vv[R], qv[R], ov[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = Ks[(ty + 16 * i) * (D + 1) + d];
        vv[i] = Vs[(ty + 16 * i) * (D + 1) + d];
        qv[i] = Qs[(tx + 16 * i) * (D + 1) + d];
        ov[i] = dOs[(tx + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j, qpos = q0 + c;
        const bool valid = qpos < a.Tq && (!CAUSAL || kpos <= qpos);
        const float sc = valid ? s[i][j] * a.scale : kNegInf;
        const float p = expf(sc - lse_s[c]);
        Ps[(ty + 16 * i) * (BQ + 1) + c] = p;
        dSs[(ty + 16 * i) * (BQ + 1) + c] = p * (dp[i][j] - dlt_s[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float ov[DPT], qv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        ov[c] = dOs[qq * (D + 1) + tx + 16 * c];
        qv[c] = Qs[qq * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = Ps[(ty + 16 * i) * (BQ + 1) + qq];
        const float ds = dSs[(ty + 16 * i) * (BQ + 1) + qq];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dv[i][c] = fmaf(p, ov[c], dv[i][c]);
          dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
        }
      }
    }
  }

  T* dkp = (T*)a.dk;
  T* dvp = (T*)a.dv;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= a.Tk) continue;
    const long long off = (((long long)bb * a.Tk + t) * a.H + hh) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dkp[off + tx + 16 * c] = Cvt<T>::from_f(dk[i][c] * a.scale);
      dvp[off + tx + 16 * c] = Cvt<T>::from_f(dv[i][c]);
    }
  }
}

// ------------------------------------------------------------ dispatch
enum Which { kDQ, kDKV };

template <Which W, typename T, int D, bool C>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  auto kern = W == kDQ ? flash_bwd_dq_kernel<T, D, C>
                       : flash_bwd_dkv_kernel<T, D, C>;
  const size_t smem = W == kDQ ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = W == kDQ ? (a.Tq + BQ - 1) / BQ : (a.Tk + BK - 1) / BK;
  dim3 grid(tiles, a.H, B);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <Which W, typename T, int D>
int by_causal(int causal, const BwdArgs& a, int B, cudaStream_t s) {
  return causal ? launch<W, T, D, true>(a, B, s)
                : launch<W, T, D, false>(a, B, s);
}

template <Which W, typename T>
int by_d(int D, int causal, const BwdArgs& a, int B, cudaStream_t s) {
  switch (D) {
    case 32: return by_causal<W, T, 32>(causal, a, B, s);
    case 64: return by_causal<W, T, 64>(causal, a, B, s);
    case 128: return by_causal<W, T, 128>(causal, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <Which W>
int run(int dtype, int causal, const BwdArgs& a, int B, int D, void* stream) {
  if (B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return by_d<W, float>(D, causal, a, B, s);
  if (dtype == kBF16) return by_d<W, __nv_bfloat16>(D, causal, a, B, s);
  return (int)cudaErrorInvalidValue;
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  int H, int Tq, int Tk, const long long* st, float scale) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.H = H; a.Tq = Tq; a.Tk = Tk; a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = st[i]; a.sk[i] = st[3 + i]; a.sv[i] = st[6 + i];
    a.sd[i] = st[9 + i];
  }
  return a;
}

}  // namespace
}  // namespace dl4j

// q/dout [B, Tq, H, D] and k/v [B, Tk, H, D] in `dtype`, addressed
// through their batch/time/head strides (in elements, D contiguous):
// strides = {q: b, t, h, k: b, t, h, v: b, t, h, dout: b, t, h}. lse and
// delta are contiguous [B, H, Tq] fp32. dq is a contiguous
// [B, Tq, H, D], dk/dv contiguous [B, Tk, H, D], in `dtype`. D must be
// 32, 64 or 128. Each returns cudaGetLastError() after its launch.
extern "C" int dl4j_flash_attention_bwd_dq(
    int dtype, int causal, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq, int B,
    int Tq, int Tk, int H, int D, const long long* strides, float scale,
    void* stream) {
  dl4j::BwdArgs a = dl4j::make_args(q, k, v, dout, lse, delta, H, Tq, Tk,
                                    strides, scale);
  a.dq = dq;
  return dl4j::run<dl4j::kDQ>(dtype, causal, a, B, D, stream);
}

extern "C" int dl4j_flash_attention_bwd_dkv(
    int dtype, int causal, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, int B, int Tq, int Tk, int H, int D, const long long* strides,
    float scale, void* stream) {
  dl4j::BwdArgs a = dl4j::make_args(q, k, v, dout, lse, delta, H, Tq, Tk,
                                    strides, scale);
  a.dk = dk;
  a.dv = dv;
  return dl4j::run<dl4j::kDKV>(dtype, causal, a, B, D, stream);
}
