// Flash-attention backward for Hopper (sm_90a) on the tensor cores: the
// dQ kernel and the dK/dV kernel.
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
// Bound: per visible (q, k) pair dQ does 6 D FLOPs (s, dp, dq) and dK/dV
// 8 D (s, dp, dv, dk). At [16, 512, 8, 32] causal that is 3.2 and 4.3
// GFLOP against 42 and 50 MB (fp32; half in bf16) of reads and writes:
// in bf16 the bytes bound both (6.4 and 7.7 us at 3.35 TB/s, against
// 3.3 and 4.4 us of operations at 989 TFLOP/s); in fp32 the operations
// do (19 and 26 us at 165 TFLOP/s, the 3xTF32 rate: 495 / 3).
//
// Design: the TPU's sequential minor grid dimension becomes a loop inside
// the block, and the JAX package's split is kept, so no block writes what
// another writes: no atomics, and results do not depend on scheduling.
//   dQ: one block per (batch, head, 64-row q tile). Q and dO stay in
//       shared memory; the block streams K/V tiles of BN rows.
//   dK/dV: one block per (batch, head, 64-row k tile). K and V stay in
//       shared memory; the block streams Q/dO/lse/delta tiles of BN rows.
// BN is 64, or 32 at D = 128 so the accumulators fit in registers. 4
// warps a block; each owns 16 rows of the block's tile and computes, for
// each streamed tile, its 16 x BN strip of S and dP (first products,
// A = its rows of the stationary tile, B = the streamed tile), then P and
// dS in fp32 registers, then the second products into its 16 x D
// accumulators (dQ; or dK and dV), A = dS or P, B = the streamed tile
// again. Every product stays inside one warp, and P and dS never touch
// shared memory:
//   bf16: mma.sync m16n8k16 (fp32 accumulators). The accumulator layout
//     of two neighbouring 8-column tiles of S/dP is the A layout of one
//     16-deep step of the second product, so P and dS are rounded to bf16
//     and packed in registers. Fragments come through ldmatrix (.trans
//     for the second products' B, which is [k][n] in shared memory).
//   fp32: 3xTF32 on mma.sync m16n8k8: each operand x = hi + lo, both
//     cvt.rna TF32, and a . b = lo.hi + hi.lo + hi.hi in fp32. A thread
//     holds accumulator columns 2t, 2t+1 of an 8-column tile but the A
//     fragment wants columns t, t+4; the second products take the
//     contraction in that permuted order instead (column 2t as k = t,
//     2t+1 as k = t+4) and read B's rows 2t, 2t+1 to match, so no shuffle
//     and no shared memory is needed.
//   The staging and these warp products (`WarpMma`) live in
//   csrc/flash_tiles.cuh, shared with the forward.
// Staging: every tile lands through cp.async (16 bytes a thread, zero
// fill past the ragged edge) in dynamic shared memory in the input dtype;
// the streamed tiles sit in a two-stage ring, the next one loading while
// the current one computes. A staged row is padded by 16 bytes, which
// puts the 8 rows of an ldmatrix and the lanes of the scalar TF32
// fragment loads (pitch = D + 4 floats: bank 4g + t, or 8t + g for the
// permuted B) on distinct banks.
// Grid: (head, batch, tile), tiles slowest. With causal masking a block's
// work grows with its tile's distance from the end of the diagonal (the
// last q tile walks every k tile; the first k tile every q tile), so
// the heaviest tiles are handed out first and the light ones fill the
// tail; in the other order the long causal launches lose about a third
// of their time to that tail (PERF.md).
// Registers a thread (sm_90a, `cuobjdump -res-usage` of the built
// library, as chip_smoke.py phase 1 prints them): fp32 dK/dV 166-168
// (D 32) and 244-255 (D 64, 128),
// fp32 dQ 154-223, bf16 dK/dV 136-241, bf16 dQ 107-166; no instance has
// a stack frame or local memory, so nothing spills. Shared memory a block:
// (2 * 64 + 4 * BN) * pitch * sizeof(T), 104 KB for fp32 at D = 64, so
// two blocks (8 warps) an SM in fp32 at D = 64.
//
// Rounding against the plain version (fp32 einsums of the same inputs):
// fp32 products are 3xTF32, within about 1e-6 of fp32 each, not bit-equal
// (1xTF32 would be off by about 1e-3). The tensor cores round their fp32
// accumulation toward zero, so the long sums of the second products go
// through fresh per-tile partials added in fp32 (`WarpMma<float>::xb`);
// the results are within 1.4e-5 of the plain version at T = 512 (values
// up to 8), under the 1e-4 tolerance. In bf16, S and dP are exact
// products summed in fp32, but P and dS are rounded to bf16 before the
// second products, as FlashAttention-2 does: within 1 bf16 ulp of the
// plain version's result. exp is ex2.approx of a log2e-scaled argument.
// Sums run in another order than the plain einsums.

#include "flash_tiles.cuh"

namespace dl4j {
namespace {

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

// ------------------------------------------------------------------ dQ
template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * (size_t)(2 * BM + 4 * stream_rows<D>()) * pitch<T, D>();
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int BN = stream_rows<D>(), P = pitch<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BM][P]
  T* dOs = Qs + BM * P;                // [BM][P]
  T* Ks = dOs + BM * P;                // [2][BN][P]
  T* Vs = Ks + 2 * BN * P;             // [2][BN][P]

  // tiles are the slowest grid axis; with causal masking the heaviest
  // q tiles (the last) are handed out first
  const int tile = CAUSAL ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = tile * BM, hh = blockIdx.x, bb = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qp = (const T*)a.q + bb * a.sq[0] + hh * a.sq[2];
  const T* kp = (const T*)a.k + bb * a.sk[0] + hh * a.sk[2];
  const T* vp = (const T*)a.v + bb * a.sv[0] + hh * a.sv[2];
  const T* dop = (const T*)a.dout + bb * a.sd[0] + hh * a.sd[2];
  const long long row0 = ((long long)bb * a.H + hh) * a.Tq;

  int n_k = (a.Tk + BN - 1) / BN;
  if (CAUSAL) {
    const int last = (q0 + BM - 1) / BN;  // tiles past the diagonal skip
    n_k = n_k < last + 1 ? n_k : last + 1;
  }
  load_rows<T, D, BM>(Qs, qp, a.sq[1], q0, a.Tq);
  load_rows<T, D, BM>(dOs, dop, a.sd[1], q0, a.Tq);
  load_rows<T, D, BN>(Ks, kp, a.sk[1], 0, a.Tk);
  load_rows<T, D, BN>(Vs, vp, a.sv[1], 0, a.Tk);
  cp_async_commit();

  // this thread's two q rows, and their lse (log2 scale) and delta
  const int r[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = r[i] < a.Tq ? a.lse[row0 + r[i]] * kLog2e : 0.f;
    dlt[i] = r[i] < a.Tq ? a.delta[row0 + r[i]] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1, k0 = kt * BN;
    if (kt + 1 < n_k) {  // the next tile loads while this one computes
      load_rows<T, D, BN>(Ks + (st ^ 1) * BN * P, kp, a.sk[1], k0 + BN, a.Tk);
      load_rows<T, D, BN>(Vs + (st ^ 1) * BN * P, vp, a.sv[1], k0 + BN, a.Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BN * P;
    const T* Vt = Vs + st * BN * P;

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    WarpMma<T>::template abt<D, BN, P>(s, Qs + 16 * warp * P, Kt, lane);
    WarpMma<T>::template abt<D, BN, P>(dp, dOs + 16 * warp * P, Vt, lane);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kpos = k0 + n * 8 + 2 * t + (e & 1);
        const bool valid = kpos < a.Tk && (!CAUSAL || kpos <= r[i]);
        const float p =
            ex2(valid ? fmaf(s[n][e], sl2, -lse2[i]) : kNegInf);
        s[n][e] = p * (dp[n][e] - dlt[i]);  // ds
      }
    WarpMma<T>::template xb<D, BN, P>(acc, s, Kt, lane);
    __syncthreads();  // every warp is done with this stage
  }

  T* dq = (T*)a.dq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= a.Tq) continue;
    T* row = dq + (((long long)bb * a.Tq + r[i]) * a.H + hh) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(row + n * 8, acc[n][2 * i] * a.scale,
                acc[n][2 * i + 1] * a.scale);
  }
}

// --------------------------------------------------------------- dK/dV
template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(T) * (size_t)(2 * BM + 4 * stream_rows<D>()) * pitch<T, D>() +
         sizeof(float) * 4 * (size_t)stream_rows<D>();
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int BN = stream_rows<D>(), P = pitch<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [BM][P]
  T* Vs = Ks + BM * P;                 // [BM][P]
  T* Qs = Vs + BM * P;                 // [2][BN][P]
  T* dOs = Qs + 2 * BN * P;            // [2][BN][P]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BN * P);  // [2][BN]
  float* dlt_s = lse_s + 2 * BN;                              // [2][BN]

  // tiles are the slowest grid axis: with causal masking the heaviest
  // k tiles (the first) are handed out first
  const int k0 = blockIdx.z * BM, hh = blockIdx.x, bb = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qp = (const T*)a.q + bb * a.sq[0] + hh * a.sq[2];
  const T* kp = (const T*)a.k + bb * a.sk[0] + hh * a.sk[2];
  const T* vp = (const T*)a.v + bb * a.sv[0] + hh * a.sv[2];
  const T* dop = (const T*)a.dout + bb * a.sd[0] + hh * a.sd[2];
  const long long row0 = ((long long)bb * a.H + hh) * a.Tq;

  const int n_q = (a.Tq + BN - 1) / BN;
  // causal: q tiles whose last row lies before this k tile skip
  const int qt0 = CAUSAL ? k0 / BN : 0;
  auto load_q_tile = [&](int stage, int qt) {
    const int q0 = qt * BN;
    load_rows<T, D, BN>(Qs + stage * BN * P, qp, a.sq[1], q0, a.Tq);
    load_rows<T, D, BN>(dOs + stage * BN * P, dop, a.sd[1], q0, a.Tq);
    if (threadIdx.x < 2 * BN) {
      const int i = threadIdx.x % BN, q = q0 + i;
      const float* src = threadIdx.x < BN ? a.lse : a.delta;
      float* dst = (threadIdx.x < BN ? lse_s : dlt_s) + stage * BN + i;
      cp_async_4(dst, q < a.Tq ? src + row0 + q : src, q < a.Tq);
    }
  };
  // a causal k tile past every query has no work: it stages nothing (no
  // copy left in flight at exit) and writes zeros
  if (qt0 < n_q) {
    load_rows<T, D, BM>(Ks, kp, a.sk[1], k0, a.Tk);
    load_rows<T, D, BM>(Vs, vp, a.sv[1], k0, a.Tk);
    load_q_tile(0, qt0);
  }
  cp_async_commit();

  // this thread's two k rows
  const int r[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const float sl2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * BN;
    if (qt + 1 < n_q) {  // the next tile loads while this one computes
      load_q_tile(st ^ 1, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * BN * P;
    const T* dOt = dOs + st * BN * P;
    const float* lse_t = lse_s + st * BN;
    const float* dlt_t = dlt_s + st * BN;

    // transposed tiles: rows are this warp's keys, columns the queries
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    WarpMma<T>::template abt<D, BN, P>(s, Ks + 16 * warp * P, Qt, lane);
    WarpMma<T>::template abt<D, BN, P>(dp, Vs + 16 * warp * P, dOt, lane);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int c = n * 8 + 2 * t;  // this thread's columns c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + c + (e & 1), kpos = r[e >> 1];
        const bool valid = qpos < a.Tq && (!CAUSAL || kpos <= qpos);
        const float lse = e & 1 ? l2.y : l2.x, dlt = e & 1 ? d2.y : d2.x;
        const float p =
            ex2(valid ? fmaf(s[n][e], sl2, -lse * kLog2e) : kNegInf);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dlt);  // ds
      }
    }
    WarpMma<T>::template xb<D, BN, P>(dv, s, dOt, lane);
    WarpMma<T>::template xb<D, BN, P>(dk, dp, Qt, lane);
    __syncthreads();  // every warp is done with this stage
  }

  T* dkp = (T*)a.dk;
  T* dvp = (T*)a.dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= a.Tk) continue;
    const long long off = (((long long)bb * a.Tk + r[i]) * a.H + hh) * D +
                          2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2<T>(dkp + off + n * 8, dk[n][2 * i] * a.scale,
                dk[n][2 * i + 1] * a.scale);
      store2<T>(dvp + off + n * 8, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ dispatch
enum Which { kDQ, kDKV };

template <Which W, typename T, int D, bool C>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  auto kern = W == kDQ ? flash_bwd_dq_kernel<T, D, C>
                       : flash_bwd_dkv_kernel<T, D, C>;
  const size_t smem =
      W == kDQ ? dq_smem_bytes<T, D>() : dkv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((W == kDQ ? a.Tq : a.Tk) + BM - 1) / BM;
  dim3 grid(a.H, B, tiles);
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

// cp.async moves 16 bytes at a time: q, k, v and dout must have every
// row start 16-byte aligned
bool aligned16(const BwdArgs& a, int elem) {
  return rows_aligned16(a.q, a.sq, elem) && rows_aligned16(a.k, a.sk, elem) &&
         rows_aligned16(a.v, a.sv, elem) &&
         rows_aligned16(a.dout, a.sd, elem);
}

template <Which W>
int run(int dtype, int causal, const BwdArgs& a, int B, int D, void* stream) {
  if (B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (!aligned16(a, dtype == kF32 ? 4 : 2))
    return (int)cudaErrorMisalignedAddress;
  if (dtype == kF32) return by_d<W, float>(D, causal, a, B, s);
  return by_d<W, __nv_bfloat16>(D, causal, a, B, s);
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
// through their batch/time/head strides (in elements, D contiguous, every
// row 16-byte aligned): strides = {q: b, t, h, k: b, t, h, v: b, t, h,
// dout: b, t, h}. lse and delta are contiguous [B, H, Tq] fp32. dq is a
// contiguous [B, Tq, H, D], dk/dv contiguous [B, Tk, H, D], in `dtype`.
// D must be 32, 64 or 128. Each returns cudaGetLastError() after its
// launch, or the error that kept it from launching.
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
