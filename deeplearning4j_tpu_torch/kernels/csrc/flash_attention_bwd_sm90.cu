// Flash-attention dK/dV backward for Hopper (sm_90a), bf16:
// warp-specialised, TMA-fed, on wgmma. The fp32 instances and the dQ
// kernel (both dtypes) stay the mma.sync kernels of
// csrc/flash_attention_bwd.cu.
//
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:307, driven by
// `_bwd_dkv_chunk` -> pallas_call :434) for bf16 inputs. It recomputes
// the probabilities from the forward's lse:
//   s = (q . k) * scale, masked with -1e30 (k_pos <= q_pos when causal,
//   and query rows past Tq), p = exp(s - lse), ds = p * (dO . v - delta),
//   dV = sum_q p^T dO, dK = scale * sum_q ds^T q.
// No atomics: a block owns its k rows, so results do not depend on
// scheduling and two launches on the same inputs are bit-equal.
//
// Bound: 8 D FLOPs per visible (q, k) pair (s, dp, dv, dk) against reads
// of q, k, v, dO, lse, delta and writes of dk, dv. At [8, 2048, 8, 64]
// causal: 68.7 GFLOP, 69.5 us at 989 TFLOP/s, against 30.4 us of bytes
// (101.7 MB at 3.35 TB/s): the operations bound it.
//
// Design: one block per (128-row k tile, head, batch), 3 warpgroups:
//   producer (warpgroup 0, setmaxnreg 24): one thread loads the K and V
//     tiles once by TMA and streams the Q and dO tiles (64 queries; 32
//     at D = 128) through a 4-stage ring; the 32 lanes of its first warp
//     stage each tile's lse (in log2 units) and delta rows beside them
//     and arrive on the stage's full barrier with it.
//   consumers (warpgroups 1, 2; setmaxnreg 240), each owning 64 k rows.
//     For each streamed q tile, the transposed scores come straight out
//     of the first products, so both second products take their A from
//     registers with no shared-memory round trip:
//       S^T = K Q^T and dP^T = V dO^T: SS wgmma m64n{BQ}k16, all K-major,
//         the first step with scale-d 0 (fresh accumulators).
//       P^T = 2^(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T -
//         delta) in fp32 registers, rounded to bf16 (as FlashAttention-2/3
//         do) and packed as A fragments.
//       dV += P^T dO and dK += dS^T Q: RS wgmma m64n{DB}k16, B (dO, Q)
//         MN-major from shared memory, chained through the accumulators
//         across tiles (the first tile's from zero, scale-d 0).
//     Software-pipelined as the forward: in one step a consumer issues
//     S^T, dP^T of q tile i and the dV, dK products of tile i - 1, then
//     computes tile i's P^T and dS^T while those run; the two consumers
//     issue independently. The fragments sit in two register
//     buffers that take turns, so no instruction writes one an in-flight
//     wgmma reads. A stage is released once its dV, dK products are in.
//   scale is applied to dK at the end. Masks are applied only where this
//   warp's 16 k rows cross the diagonal or the q tile crosses Tq.
// Grid: (head, batch, tile), tiles slowest: with causal masking the
// first k tiles walk the most q tiles and are handed out first; a k tile
// past every query (Tk > Tq) loads nothing and writes zeros. (A
// persistent grid, as the forward's, measured slower here: its items
// are long, 17 q tiles on average at [8, 2048, 8, 64], so the start of
// a block costs little, and the card's block scheduler balances them
// better; PERF.md.)
// Shared memory a block: K, V, 4 Q and 4 dO tiles, lse and delta, and
// 2 KB: 52 KB at D = 32, 100 KB at D = 64, 131 KB at D = 128. 384 threads
// at 168 registers (consumers 240 after setmaxnreg); no instance spills.
//
// Rounding against the plain version (fp32 einsums of the same inputs):
// S and dP are exact bf16 products summed in fp32; P and dS are rounded
// to bf16 before the second products, as FlashAttention-2/3 do. exp is
// ex2.approx of a log2e-scaled argument.

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace dl4j {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kThreads = 3 * kWG;  // producer + two consumers
constexpr int kKRows = 128;        // k rows a block, 64 a consumer
constexpr int kStages = 4;

// queries a streamed tile: 64, or 32 at D = 128 where the registers a
// consumer keeps for two tiles at once (S^T and dP^T of one, P^T and
// dS^T of the previous, beside dK and dV) would not fit otherwise
template <int D>
__host__ __device__ constexpr int q_rows() {
  return D == 128 ? 32 : 64;
}

struct DkvArgs {
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dk;            // [B, Tk, H, D] bf16
  void* dv;
  int H, Tq, Tk;
  float scale;
};

template <int D>
constexpr int dkv_smem_bytes() {
  return 2 * Box<D>::bytes(kKRows) +
         2 * kStages * Box<D>::bytes(q_rows<D>()) +
         2 * kStages * q_rows<D>() * 4 /* lse, delta */ +
         1024 /* barriers */ + 1024 /* alignment */;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// acc = A . B from zero for this consumer's 64 k rows: A = its rows of
// the K-major tile X (K or V), B = the K-major streamed tile Y (Q or
// dO). The first product ignores acc (scale-d 0: no instruction but the
// wgmma writes it, which keeps ptxas from serialising the products).
template <int D, int BQ>
__device__ __forceinline__ void issue_first(float (&acc)[BQ / 8][4],
                                            uint64_t X, int c, uint64_t Y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BQ>(acc, desc_k<D>(X, kKRows, 64 * c, kk),
                 desc_k<D>(Y, BQ, 0, kk), kk > 0);
}

// acc += A . Y (acc = A . Y for the first tile), A from registers (P^T
// or dS^T), Y (dO or Q) MN-major: one RS product a k16 step and
// DB-column box of Y
template <int D, int BQ>
__device__ __forceinline__ void issue_second(float (&acc)[D / 8][4],
                                             const uint32_t (&a)[BQ / 16][4],
                                             uint64_t Y, bool first) {
  using L = Box<D>;
#pragma unroll
  for (int j = 0; j < L::NB; ++j) {
    auto& aj = *reinterpret_cast<float(*)[L::DB / 8][4]>(acc[j * L::DB / 8]);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<L::DB>(aj, a[kk], desc_mn<D>(Y, BQ, j, kk),
                      !(first && kk == 0));
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                              __grid_constant__ const CUtensorMap tk,
                              __grid_constant__ const CUtensorMap tv,
                              __grid_constant__ const CUtensorMap tdo,
                              DkvArgs a) {
  using L = Box<D>;
  constexpr int BQ = q_rows<D>();
  constexpr int KB = L::bytes(kKRows), QB = L::bytes(BQ);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  bf16* Ks = reinterpret_cast<bf16*>(base);
  bf16* Vs = reinterpret_cast<bf16*>(base + KB);
  bf16* Qs = reinterpret_cast<bf16*>(base + 2 * KB);  // [kStages] tiles
  bf16* dOs = reinterpret_cast<bf16*>(base + 2 * KB + kStages * QB);
  float* lse_s = reinterpret_cast<float*>(base + 2 * KB + 2 * kStages * QB);
  float* dlt_s = lse_s + kStages * BQ;  // [kStages][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dlt_s + kStages * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.z * kKRows, hh = blockIdx.x, bb = blockIdx.y;
  const long long row0 = ((long long)bb * a.H + hh) * a.Tq;
  const int n_q = (a.Tq + BQ - 1) / BQ;
  // causal: q tiles whose last row lies before this k tile skip
  const int qt0 = CAUSAL ? k0 / BQ : 0;
  const int nt = qt0 < n_q ? n_q - qt0 : 0;  // q tiles this block walks

  if (threadIdx.x == 0) {
    prefetch_tma(&tq);
    prefetch_tma(&tk);
    prefetch_tma(&tv);
    prefetch_tma(&tdo);
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 2 * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {  // ---------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32 && nt > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KB);
        tma_load_rows<D>(Ks, &tk, kv_full, kKRows, hh, k0, bb);
        tma_load_rows<D>(Vs, &tv, kv_full, kKRows, hh, k0, bb);
      }
      for (int i = 0; i < nt; ++i) {
        const int st = i % kStages, q0 = (qt0 + i) * BQ;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
#pragma unroll
        for (int h = 0; h < BQ / 32; ++h) {
          const int q = q0 + h * 32 + lane;
          const bool in = q < a.Tq;
          lse_s[st * BQ + h * 32 + lane] =
              in ? a.lse[row0 + q] * kLog2e : 0.f;  // log2 units
          dlt_s[st * BQ + h * 32 + lane] = in ? a.delta[row0 + q] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * QB);
          tma_load_rows<D>(Qs + st * BQ * D, &tq, &full[st], BQ, hh, q0, bb);
          tma_load_rows<D>(dOs + st * BQ * D, &tdo, &full[st], BQ, hh, q0,
                           bb);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  // Software-pipelined as the forward: in one step a consumer issues S^T
  // and dP^T of q tile i and the dV, dK products of tile i - 1 together,
  // then computes tile i's P^T and dS^T while those run.
  setmaxnreg_inc<240>();
  const int c = wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int rw = k0 + 64 * c + 16 * warp;  // this warp's first k row
  const int r[2] = {rw + (lane >> 2), rw + (lane >> 2) + 8};  // this thread's
  const float sl2 = a.scale * kLog2e;

  // dK and dV: written by the products alone (the first tile's from
  // zero), or zero when this block walks no q tile
  float dk[D / 8][4], dv[D / 8][4];

  // P^T = 2^(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - delta)
  // of q tile i (scores masked with -1e30 only where this warp's k rows
  // cross the diagonal or the tile crosses Tq), rounded to bf16 into the
  // A fragments pa_, da_ (k16 step kk is the accumulator's 8-column
  // tiles 2 kk and 2 kk + 1)
  auto elementwise = [&](float (&s)[BQ / 8][4], float (&dp)[BQ / 8][4],
                         int i, uint32_t (&pa_)[BQ / 16][4],
                         uint32_t (&da_)[BQ / 16][4]) {
    const int st = i % kStages, q0 = (qt0 + i) * BQ;
    const float* lse_t = lse_s + st * BQ;
    const float* dlt_t = dlt_s + st * BQ;
    if (q0 + BQ > a.Tq || (CAUSAL && rw + 15 > q0)) {
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + n * 8 + 2 * t + (e & 1), kpos = r[e >> 1];
          if (!(qpos < a.Tq && (!CAUSAL || kpos <= qpos)))
            s[n][e] = kNegInf;
        }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const int cq = n * 8 + 2 * t;  // this thread's columns cq, cq + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = e & 1 ? l2.y : l2.x, dlt = e & 1 ? d2.y : d2.x;
        const float p = ex2(fmaf(s[n][e], sl2, -lse2));
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dlt);  // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 2 * kk + (j >> 1), e = 2 * (j & 1);
        pa_[kk][j] = pack_bf16(s[n][e], s[n][e + 1]);
        da_[kk][j] = pack_bf16(dp[n][e], dp[n][e + 1]);
      }
  };

  const uint64_t Kd = tile_desc<D>(Ks), Vd = tile_desc<D>(Vs);
  // P^T and dS^T of a tile waiting for their products, in two buffers
  // that take turns (no register copy between a product's issue and its
  // wait)
  uint32_t pa0[BQ / 16][4], da0[BQ / 16][4], pa1[BQ / 16][4],
      da1[BQ / 16][4];
  // q tile i's S^T, dP^T and tile i - 1's dV, dK products (from pa_in,
  // da_in) issued together; tile i's P^T, dS^T into pa_out, da_out while
  // those run
  auto step = [&](int i, uint32_t(&pa_in)[BQ / 16][4],
                  uint32_t(&da_in)[BQ / 16][4],
                  uint32_t(&pa_out)[BQ / 16][4],
                  uint32_t(&da_out)[BQ / 16][4]) {
    const int st = i % kStages, pst = (i - 1) % kStages;
    float s[BQ / 8][4], dp[BQ / 8][4];
    mbar_wait(&full[st], (i / kStages) & 1);
    wgmma_fence();
    issue_first<D, BQ>(s, Kd, c, tile_desc<D>(Qs + st * BQ * D));
    issue_first<D, BQ>(dp, Vd, c, tile_desc<D>(dOs + st * BQ * D));
    wgmma_commit();
    issue_second<D, BQ>(dv, pa_in, tile_desc<D>(dOs + pst * BQ * D),
                        i == 1);
    issue_second<D, BQ>(dk, da_in, tile_desc<D>(Qs + pst * BQ * D),
                        i == 1);
    wgmma_commit();
    wgmma_wait<1>();  // S^T and dP^T are in
    fence_regs(s);
    fence_regs(dp);
    elementwise(s, dp, i, pa_out, da_out);
    // done before the wait below (the compiler may move register
    // arithmetic across an asm statement, not asm statements across each
    // other), so it runs while the dV, dK products do
    fence_regs(pa_out);
    fence_regs(da_out);
    wgmma_wait<0>();  // dV, dK of the previous tile are in
    fence_regs(dv);
    fence_regs(dk);
    // pa_in, da_in stay live to here, so pa_out, da_out never take their
    // registers while the products still read them
    fence_regs(pa_in);
    fence_regs(da_in);
    mbar_arrive(&empty[pst]);  // this thread is done with that stage
  };
  // the last tile's dV, dK products (from pa_in, da_in)
  auto last = [&](const uint32_t(&pa_in)[BQ / 16][4],
                  const uint32_t(&da_in)[BQ / 16][4]) {
    const int pst = (nt - 1) % kStages;
    wgmma_fence();
    issue_second<D, BQ>(dv, pa_in, tile_desc<D>(dOs + pst * BQ * D),
                        nt == 1);
    issue_second<D, BQ>(dk, da_in, tile_desc<D>(Qs + pst * BQ * D),
                        nt == 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  };

  if (nt == 0) {
    zero(dk);
    zero(dv);
  } else {
    mbar_wait(kv_full, 0);
    {  // q tile 0: the first products alone
      float s[BQ / 8][4], dp[BQ / 8][4];
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_first<D, BQ>(s, Kd, c, tile_desc<D>(Qs));
      issue_first<D, BQ>(dp, Vd, c, tile_desc<D>(dOs));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      elementwise(s, dp, 0, pa0, da0);
    }
    int i = 1;
    for (; i + 1 < nt; i += 2) {
      step(i, pa0, da0, pa1, da1);
      step(i + 1, pa1, da1, pa0, da0);
    }
    if (i < nt) {
      step(i, pa0, da0, pa1, da1);
      last(pa1, da1);
    } else {
      last(pa0, da0);
    }
  }

  bf16* dkp = (bf16*)a.dk;
  bf16* dvp = (bf16*)a.dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= a.Tk) continue;
    const long long off =
        (((long long)bb * a.Tk + r[i]) * a.H + hh) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2<bf16>(dkp + off + n * 8, dk[n][2 * i] * a.scale,
                   dk[n][2 * i + 1] * a.scale);
      store2<bf16>(dvp + off + n * 8, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D, bool CAUSAL>
int launch(const CUtensorMap (&maps)[4], const DkvArgs& a, int B,
           cudaStream_t stream) {
  auto kern = flash_bwd_dkv_sm90_kernel<D, CAUSAL>;
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B, (a.Tk + kKRows - 1) / kKRows);
  kern<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                         a);
  return (int)cudaGetLastError();
}

template <int D>
int by_causal(int causal, const void* const (&ptrs)[4], const long long* L,
              const DkvArgs& a, int B, cudaStream_t s) {
  // q's and dO's maps load q_rows<D>()-row tiles of Tq rows, k's and
  // v's 128-row tiles of Tk rows
  if (!layout_is<D>(L, B, a.Tq, a.H, q_rows<D>()) ||
      !layout_is<D>(L + 12, B, a.Tk, a.H, kKRows) ||
      !layout_is<D>(L + 24, B, a.Tk, a.H, kKRows) ||
      !layout_is<D>(L + 36, B, a.Tq, a.H, q_rows<D>()))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int err = encode_tma(&maps[i], ptrs[i], L + 12 * i);
    if (err) return err;
  }
  return causal ? launch<D, true>(maps, a, B, s)
                : launch<D, false>(maps, a, B, s);
}

}  // namespace
}  // namespace dl4j

// q/dout [B, Tq, H, D] and k/v [B, Tk, H, D] in bf16 (dtype code 1; any
// other is refused), described by `maps`: 12 numbers each for q, k, v,
// dout, as `_tma_layout` works them out. lse and delta are contiguous
// [B, H, Tq] fp32; dk/dv contiguous [B, Tk, H, D] bf16. D must be 32, 64
// or 128. Returns cudaGetLastError() after the launch, or the error that
// kept it from launching.
extern "C" int dl4j_flash_attention_bwd_dkv_sm90(
    int dtype, int causal, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, int B, int Tq, int Tk, int H, int D, const long long* maps,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return 0;
  if (dtype != dl4j::kBF16) return (int)cudaErrorInvalidValue;
  dl4j::DkvArgs a{};
  a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  a.H = H; a.Tq = Tq; a.Tk = Tk; a.scale = scale;
  const void* const ptrs[4] = {q, k, v, dout};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return dl4j::by_causal<32>(causal, ptrs, maps, a, B, s);
    case 64: return dl4j::by_causal<64>(causal, ptrs, maps, a, B, s);
    case 128: return dl4j::by_causal<128>(causal, ptrs, maps, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
