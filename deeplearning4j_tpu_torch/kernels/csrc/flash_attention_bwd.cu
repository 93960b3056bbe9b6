// Flash-attention backward on the tensor cores with mma.sync: the fp32
// dK/dV kernel. The bf16 dK/dV and the dQ in both dtypes are the Hopper
// kernels of csrc/flash_attention_bwd_sm90.cu (wgmma, TMA,
// warp-specialised).
//
// Replaces, for fp32 inputs, the Pallas TPU kernel
// `_flash_bwd_dkv_kernel` (deeplearning4j_tpu/kernels/flash_attention.py:307,
// driven by `_bwd_dkv_chunk` -> pallas_call :434).
//
// It recomputes the probabilities from the forward's lse instead of
// storing the [T, T] matrix:
//   s  = (q . k) * scale, masked with -1e30 (the JAX value, not -inf)
//   p  = exp(s - lse)
//   dp = dO . v,  ds = p * (dp - delta),  delta = rowsum(dO * O)
//   dV = sum_q p^T dO,   dK = scale * sum_q ds^T q
// Query rows past Tq are masked, and with causal masking k_pos <= q_pos;
// tiles wholly on the masked side of the diagonal are skipped, as the
// Pallas kernel skips them.
//
// Bound: 8 D FLOPs per visible (q, k) pair (s, dp, dv, dk). At [16, 512,
// 8, 32] causal that is 4.3 GFLOP against 50 MB of reads and writes: the
// operations bound it (26 us at 165 TFLOP/s, the 3xTF32 rate: 495 / 3).
//
// Design: the TPU's sequential minor grid dimension becomes a loop inside
// the block, and the JAX package's split is kept, so no block writes what
// another writes: no atomics, and results do not depend on scheduling.
// One block per (batch, head, 64-row k tile). K and V stay in shared
// memory; the block streams Q/dO/lse/delta tiles of BN rows, BN = 64, or
// 32 at D = 128 so the accumulators fit in registers. 4 warps a block;
// each owns 16 rows of the block's tile and computes, for each streamed
// tile, its 16 x BN strip of S^T and dP^T (first products, A = its rows
// of K or V, B = the streamed tile), then P^T and dS^T in fp32
// registers, then the second products into its 16 x D accumulators dK
// and dV, A = dS^T or P^T, B = the streamed tile again. Every product
// stays inside one warp, and P and dS never touch shared memory. The
// products are 3xTF32 on mma.sync m16n8k8: each operand x = hi + lo,
// both cvt.rna TF32, and a . b = lo.hi + hi.lo + hi.hi in fp32. A thread
// holds accumulator columns 2t, 2t+1 of an 8-column tile but the A
// fragment wants columns t, t+4; the second products take the
// contraction in that permuted order instead (column 2t as k = t, 2t+1
// as k = t+4) and read B's rows 2t, 2t+1 to match, so no shuffle and no
// shared memory is needed. The staging and these warp products
// (`WarpMma`) live in csrc/flash_tiles.cuh, shared with the fp32 forward.
// Staging: every tile lands through cp.async (16 bytes a thread, zero
// fill past the ragged edge) in dynamic shared memory; the streamed
// tiles sit in a two-stage ring, the next one loading while the current
// one computes. A staged row is padded by 16 bytes, which puts the lanes
// of the scalar TF32 fragment loads (pitch = D + 4 floats: bank 4g + t,
// or 8t + g for the permuted B) on distinct banks.
// Grid: (head, batch, tile), tiles slowest. With causal masking a block's
// work grows with its tile's distance from the end of the diagonal (the
// first k tile walks every q tile), so the heaviest tiles are handed out
// first and the light ones fill the tail; in the other order the long
// causal launches lose about a third of their time to that tail
// (PERF.md).
// Registers a thread (sm_90a, `cuobjdump -res-usage` of the built
// library, as chip_smoke.py phase 1 prints them): 166-168 (D 32) and
// 244-255 (D 64, 128); no instance has a stack frame or local memory, so
// nothing spills. Shared memory a block: (2 * 64 + 4 * BN) * pitch * 4
// bytes plus the lse and delta tiles, 104 KB at D = 64, so two blocks (8
// warps) an SM at D = 64.
//
// Rounding against the plain version (fp32 einsums of the same inputs):
// the products are 3xTF32, within about 1e-6 of fp32 each, not bit-equal
// (1xTF32 would be off by about 1e-3). The tensor cores round their fp32
// accumulation toward zero, so the long sums of the second products go
// through fresh per-tile partials added in fp32 (`WarpMma<float>::xb`);
// the results are within 1.4e-5 of the plain version at T = 512 (values
// up to 8), under the 1e-4 tolerance. exp is ex2.approx of a
// log2e-scaled argument. Sums run in another order than the plain
// einsums.

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
  void* dk;
  void* dv;
  int H, Tq, Tk;
  // element strides {b, t, h} of q, k, v, dout
  long long sq[3], sk[3], sv[3], sd[3];
  float scale;
};

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
template <typename T, int D, bool C>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D, C>;
  const size_t smem = dkv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B, (a.Tk + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_causal(int causal, const BwdArgs& a, int B, cudaStream_t s) {
  return causal ? launch<T, D, true>(a, B, s) : launch<T, D, false>(a, B, s);
}

// cp.async moves 16 bytes at a time: q, k, v and dout must have every
// row start 16-byte aligned
bool aligned16(const BwdArgs& a) {
  return rows_aligned16(a.q, a.sq, 4) && rows_aligned16(a.k, a.sk, 4) &&
         rows_aligned16(a.v, a.sv, 4) && rows_aligned16(a.dout, a.sd, 4);
}

int run(int dtype, int causal, const BwdArgs& a, int B, int D, void* stream) {
  if (B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0) return 0;
  // bf16 is the Hopper kernel of csrc/flash_attention_bwd_sm90.cu
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  if (!aligned16(a)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return by_causal<float, 32>(causal, a, B, s);
    case 64: return by_causal<float, 64>(causal, a, B, s);
    case 128: return by_causal<float, 128>(causal, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// q/dout [B, Tq, H, D] and k/v [B, Tk, H, D] in fp32 (dtype code 0;
// bf16 is refused, its kernel is dl4j_flash_attention_bwd_dkv_sm90),
// addressed through their batch/time/head strides (in elements, D
// contiguous, every row 16-byte aligned): strides = {q: b, t, h, k: b,
// t, h, v: b, t, h, dout: b, t, h}. lse and delta are contiguous
// [B, H, Tq] fp32; dk/dv contiguous [B, Tk, H, D] fp32. D must be 32, 64
// or 128. Returns cudaGetLastError() after the launch, or the error that
// kept it from launching.
extern "C" int dl4j_flash_attention_bwd_dkv(
    int dtype, int causal, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, int B, int Tq, int Tk, int H, int D, const long long* strides,
    float scale, void* stream) {
  dl4j::BwdArgs a = dl4j::make_args(q, k, v, dout, lse, delta, H, Tq, Tk,
                                    strides, scale);
  a.dk = dk;
  a.dv = dv;
  return dl4j::run(dtype, causal, a, B, D, stream);
}
