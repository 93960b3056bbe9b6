// Flash-attention forward on the tensor cores with mma.sync, fp32
// (3xTF32), in its two modes. The bf16 instances are the Hopper kernel
// of csrc/flash_attention_sm90.cu (wgmma, TMA, warp-specialised).
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:87, through
// `_fwd_pallas_call`) for fp32 inputs:
// - finalize (`flash_attention` -> `_flash_forward`): per (batch, head),
//   o = softmax(q k^T / sqrt(D)) v with the online (streaming) softmax in
//   fp32, the causal mask k_pos <= q_pos and the ragged key tail masked
//   with -1e30 (the JAX kernel's value), and lse = m + log(l). Emits
//   o [B, Tq, H, D] and lse [B, H, Tq] in fp32.
// - carry (`flash_attention_carry`, carry=True, finalize=False): the
//   ring-attention fold. The running state is seeded from m, l [B, H, Tq]
//   and the unnormalised acc [B, H, Tq, D] (all fp32), one K/V chunk is
//   folded in with the same online softmax (`diag` is the causal mask
//   between local positions), and (m, l, acc) is written back IN PLACE:
//   each thread reads its own rows' state before its first tile and
//   writes it after its last, and no other block touches those rows. A
//   first fold from m = -1e30 gives corr = exp(-1e30 - m_new) = 0, as in
//   JAX; -inf must never be fed in (-inf - -inf is NaN). Tq may differ
//   from Tk when not `diag`.
//
// Bound: 4 D FLOPs per visible (q, k) pair (S and P.V) against 4
// reads/writes of a [B, T, H, D] tensor; carry adds a read and a write of
// the fp32 state, 8 (D + 2) bytes a row. At [16, 512, 8, 32] causal that
// is 2.2 GFLOP against 34 MB: the operations bound it (13 us at
// 165 TFLOP/s, the 3xTF32 rate: 495 / 3).
//
// Design: on the tiles of the fp32 dK/dV (csrc/flash_tiles.cuh, shared
// with csrc/flash_attention_bwd.cu). One block per (64-row q tile, head,
// batch), 4 warps, each owning 16 q rows; the TPU's sequential k grid
// dimension becomes the loop inside the block, and causal tiles wholly
// above the diagonal are skipped. The Q tile is staged once; K/V tiles of
// BN rows (64, or 32 at D = 128) stream through a two-stage cp.async ring,
// the next loading while the current computes, each row padded by 16
// bytes (the TF32 fragment loads on distinct banks). q/k/v are read
// through their [B, T, H, D] strides (D contiguous, rows 16-byte aligned:
// the wrappers copy anything else, and the C entries refuse it with
// cudaErrorMisalignedAddress).
//   S: each warp's 16 x BN strip of q k^T comes from mma.sync (A = its Q
//     rows, B = the K tile) into fp32 accumulators. A thread holds rows g
//     and g + 8 (g = lane / 4) and 2 columns of each 8-column tile, so a
//     row's max and sum take two __shfl_xor_sync over lanes 4g..4g+3, and
//     m and l live in registers per thread. Scores are scaled to log2
//     units (scale * log2e) and exp is ex2.approx; -1e30 stays finite.
//   P.V: P never touches shared memory: 3xTF32 on m16n8k8 (hi + lo split
//     of both operands), with the contraction permuted (column 2t as
//     k = t, 2t+1 as k = t + 4) and V's rows read to match
//     (`WarpMma<float>::xb`).
//   The tensor cores round their fp32 sums toward zero, so each streamed
//   tile's P.V is summed from zero in fresh accumulators and added in
//   fp32 to acc * corr; acc is never chained through the mma.
// Grid: (head, batch, tile), tiles slowest; with causal masking the last
// q tiles walk the most k tiles, so they are handed out first.
// Registers a thread (sm_90a, `cuobjdump -res-usage` of the built
// library, as chip_smoke.py phase 1 prints them): 128-164 at D 32 and
// 241-255 at D 64 and 128, where registers and shared memory both hold
// two blocks an SM. Six instances keep a stack frame of 8-64 B (D 64
// causal finalize the largest); none has local memory. Shared memory a
// block: (64 + 4 BN) * pitch * 4 bytes, 87 KB at D = 64.
//
// Rounding against the plain version (fp32 einsums of the same inputs):
// products are 3xTF32, within about 1e-6 of fp32 each. Sums run in
// another order than the plain einsums, and m moves to and from log2
// units.

#include "flash_tiles.cuh"

namespace dl4j {
namespace {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // finalize: [B, Tq, H, D] in the input dtype
  float* lse;    // finalize: [B, H, Tq]
  float* m;      // carry: [B, H, Tq], read and written in place
  float* l;      // carry: [B, H, Tq]
  float* acc;    // carry: [B, H, Tq, D]
  int H, Tq, Tk;
  // element strides {b, t, h} of q, k, v
  long long sq[3], sk[3], sv[3];
  float scale;
};

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * (size_t)(BM + 4 * stream_rows<D>()) * pitch<T, D>();
}

// Finalize: o, lse are written, the state pointers are unused. Carry:
// m, l [B, H, Tq] and acc [B, H, Tq, D] (contiguous fp32) are read as the
// seed and overwritten with the folded state; o, lse unused.
template <typename T, int D, bool CAUSAL, bool CARRY>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FwdArgs a) {
  constexpr int BN = stream_rows<D>(), P = pitch<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BM][P]
  T* Ks = Qs + BM * P;                 // [2][BN][P]
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
  // row (b, h, t) of the [B, H, Tq] state / lse layout is row0 + t
  const long long row0 = ((long long)bb * a.H + hh) * a.Tq;

  int n_k = (a.Tk + BN - 1) / BN;
  if (CAUSAL) {
    const int last = (q0 + BM - 1) / BN;  // tiles past the diagonal skip
    n_k = n_k < last + 1 ? n_k : last + 1;
  }
  load_rows<T, D, BM>(Qs, qp, a.sq[1], q0, a.Tq);
  load_rows<T, D, BN>(Ks, kp, a.sk[1], 0, a.Tk);
  load_rows<T, D, BN>(Vs, vp, a.sv[1], 0, a.Tk);
  cp_async_commit();

  // this thread's two q rows; m in log2 units
  const int r[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float m2[2], l[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool seed = CARRY && r[i] < a.Tq;
    m2[i] = seed ? a.m[row0 + r[i]] * kLog2e : kNegInf;
    l[i] = seed ? a.l[row0 + r[i]] : 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2 v2 = make_float2(0.f, 0.f);
      if (seed)
        v2 = *reinterpret_cast<const float2*>(a.acc + (row0 + r[i]) * D +
                                              n * 8 + 2 * t);
      acc[n][2 * i] = v2.x;
      acc[n][2 * i + 1] = v2.y;
    }
  }
  const float sl2 = a.scale * kLog2e;

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

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    WarpMma<T>::template abt<D, BN, P>(s, Qs + 16 * warp * P, Kt, lane);

    // masks only where this warp's strip crosses the diagonal or the tail
    const bool edge = k0 + BN > a.Tk ||
                      (CAUSAL && k0 + BN - 1 > q0 + 16 * warp);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kpos = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * sl2;
        if (edge && !(kpos < a.Tk && (!CAUSAL || kpos <= r[i]))) x = kNegInf;
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m2[i], mx[i]);
      corr[i] = ex2(m2[i] - m_new);
      m2[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[n][e] - m2[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    WarpMma<T>::template xb<D, BN, P>(acc, s, Vt, lane);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= a.Tq) continue;
    if (CARRY) {
      float* row = a.acc + (row0 + r[i]) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(row + n * 8) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if (t == 0) {
        a.m[row0 + r[i]] = m2[i] * kLn2;
        a.l[row0 + r[i]] = l[i];
      }
      continue;
    }
    const float ls = fmaxf(l[i], 1e-20f);
    T* row = (T*)a.o + (((long long)bb * a.Tq + r[i]) * a.H + hh) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(row + n * 8, acc[n][2 * i] / ls, acc[n][2 * i + 1] / ls);
    if (t == 0) a.lse[row0 + r[i]] = m2[i] * kLn2 + logf(ls);
  }
}

template <typename T, int D, bool CAUSAL, bool CARRY>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D, CAUSAL, CARRY>;
  const size_t smem = fwd_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B, (a.Tq + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool CARRY>
int by_causal(int causal, const FwdArgs& a, int B, cudaStream_t s) {
  return causal ? launch<T, D, true, CARRY>(a, B, s)
                : launch<T, D, false, CARRY>(a, B, s);
}

template <typename T, bool CARRY>
int by_d(int D, int causal, const FwdArgs& a, int B, cudaStream_t s) {
  switch (D) {
    case 32: return by_causal<T, 32, CARRY>(causal, a, B, s);
    case 64: return by_causal<T, 64, CARRY>(causal, a, B, s);
    case 128: return by_causal<T, 128, CARRY>(causal, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool CARRY>
int run(int dtype, int causal, const FwdArgs& a, int B, void* stream,
        int D) {
  if (B <= 0 || a.Tq <= 0 || a.H <= 0) return 0;
  if (a.Tk <= 0) return (int)cudaErrorInvalidValue;
  // bf16 is the Hopper kernel of csrc/flash_attention_sm90.cu
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  if (!rows_aligned16(a.q, a.sq, 4) || !rows_aligned16(a.k, a.sk, 4) ||
      !rows_aligned16(a.v, a.sv, 4))
    return (int)cudaErrorMisalignedAddress;
  return by_d<float, CARRY>(D, causal, a, B, (cudaStream_t)stream);
}

FwdArgs make_args(const void* q, const void* k, const void* v, int H, int Tq,
                  int Tk, const long long* st, float scale) {
  FwdArgs a{};
  a.q = q; a.k = k; a.v = v;
  a.H = H; a.Tq = Tq; a.Tk = Tk; a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = st[i]; a.sk[i] = st[3 + i]; a.sv[i] = st[6 + i];
  }
  return a;
}

}  // namespace
}  // namespace dl4j

// q [B, Tq, H, D], k/v [B, Tk, H, D] in `dtype` (fp32 only; bf16 is
// refused, its kernel is dl4j_flash_attention_fwd_sm90), addressed
// through their batch/time/head strides (in elements; the D axis
// contiguous, every row 16-byte aligned). o is a contiguous
// [B, Tq, H, D] in `dtype`, lse a contiguous [B, H, Tq] fp32. strides =
// {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh}. D must be 32, 64 or 128. Returns cudaGetLastError()
// after the launch, or the error that kept it from launching.
extern "C" int dl4j_flash_attention_fwd(int dtype, int causal, const void* q,
                                        const void* k, const void* v, void* o,
                                        float* lse, int B, int Tq, int Tk,
                                        int H, int D, const long long* strides,
                                        float scale, void* stream) {
  dl4j::FwdArgs a = dl4j::make_args(q, k, v, H, Tq, Tk, strides, scale);
  a.o = o;
  a.lse = lse;
  return dl4j::run<false>(dtype, causal, a, B, stream, D);
}

// The carry fold: q, k, v as above; m, l a contiguous [B, H, Tq] fp32 and
// acc a contiguous [B, H, Tq, D] fp32 hold the running state and are
// updated IN PLACE. `diag` masks k_pos > q_pos between local positions
// (the caller guarantees Tq == Tk then). Returns cudaGetLastError(), or
// the error that kept it from launching.
extern "C" int dl4j_flash_attention_carry(int dtype, int diag, const void* q,
                                          const void* k, const void* v,
                                          float* m, float* l, float* acc,
                                          int B, int Tq, int Tk, int H, int D,
                                          const long long* strides,
                                          float scale, void* stream) {
  dl4j::FwdArgs a = dl4j::make_args(q, k, v, H, Tq, Tk, strides, scale);
  a.m = m;
  a.l = l;
  a.acc = acc;
  return dl4j::run<true>(dtype, diag, a, B, stream, D);
}
