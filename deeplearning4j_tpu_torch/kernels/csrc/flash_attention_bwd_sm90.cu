// Flash-attention backward for Hopper (sm_90a): warp-specialised,
// TMA-fed, on wgmma. Two kernels: the bf16 dK/dV, and the dQ in bf16 and
// in fp32 (3xTF32 on tf32 wgmma). The fp32 dK/dV stays the mma.sync
// kernel of csrc/flash_attention_bwd.cu.
//
// Both recompute the probabilities from the forward's lse:
//   s = (q . k) * scale, masked with -1e30 (k_pos <= q_pos when causal,
//   keys past Tk, query rows past Tq), p = exp(s - lse),
//   ds = p * (dO . v - delta), dQ = scale * sum_k ds k,
//   dV = sum_q p^T dO, dK = scale * sum_q ds^T q.
// No atomics: a block owns its output rows, so results do not depend on
// scheduling and two launches on the same inputs are bit-equal (the
// port's bit-exact resumes need it: FlashAttention-3's atomic dQ sum is
// ruled out for this reason).
//
// ----------------------------------------------------------- dK/dV (bf16)
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:307, driven by
// `_bwd_dkv_chunk` -> pallas_call :434) for bf16 inputs.
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
//
// ------------------------------------------------------ dQ (bf16, fp32)
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:265, driven by
// `_bwd_dq_chunk` -> pallas_call :396) in both dtypes.
//
// Bound: 6 D FLOPs per visible (q, k) pair (s, dp, dq) against reads of
// q, k, v, dO, lse, delta and a write of dq. At [8, 2048, 8, 64] causal:
// 51.6 GFLOP, 52.1 us at 989 TFLOP/s (bf16) and 312.5 us at 165 TFLOP/s
// (fp32 as 3xTF32: 495 / 3), against 25.4 / 50.5 us of bytes (85 / 169
// MB at 3.35 TB/s): the operations bound it. It shares the exp2 of a
// pair with dK/dV but does 6 D FLOPs to its 8 D, so the MUFU unit (16
// exp2 a clock an SM) weighs more here.
//
// Design: the mirror of dK/dV: one block per (q tile, head, batch)
// (`DqTiles`: 64 q rows a consumer warpgroup), Q and dO resident, K and V
// streamed; grid (head, batch, tile), tiles slowest, the last (heaviest
// causal) q tiles first.
//   producer (warpgroup 0): its first warp stages the tile's lse (in
//     log2 units) and delta rows; its lane 0 loads Q and dO once by TMA
//     and streams the K/V tiles through an S-stage mbarrier ring.
//     fp32: warps 1-3 convert, because tf32 wgmma reads its shared-memory
//     operands K-major only and splits nothing itself: Q and dO once, and
//     each landed K/V stage, rounded to tf32 in place with their lo
//     halves (x - hi, rounded) beside, and K^T's hi and lo written
//     transposed (D rows of BK keys, 128B or 64B swizzled), the B operand
//     of dS K, which contracts over keys; then fence.proxy.async and an
//     arrival on the stage's conversion barrier. (Computing dQ^T = K^T
//     dS^T instead, K^T from registers, would send dS through shared
//     memory and leave D = 32 below wgmma's 64 rows; not taken.)
//   consumers (setmaxnreg 232 in bf16), each owning 64 q rows: per k tile
//       S = Q K^T and dP = dO V^T: SS wgmma m64n{BK}, all K-major, the
//         first step with scale-d 0; fp32, three products a k8 step:
//         lo.hi + hi.lo + hi.hi, small terms first (3xTF32, as the
//         mma.sync kernels' `mma_3xtf32`). Shared memory's bandwidth
//         bounds these: at fp32 D = 64 the lo halves of Q and dO are A
//         fragments in registers (RS), loaded once (`LO_REGS`).
//       P = 2^(S scale log2e - lse log2e) and dS = P (dP - delta) in fp32
//         registers; bf16, dS rounded to bf16 and packed as A fragments;
//         fp32, split into tf32 hi and lo fragments, a thread's columns
//         2t, 2t + 1 entering as k = t, t + 4 (the m16n8k8 A layout), to
//         match which each 8 keys of K^T are stored 0 2 4 6 1 3 5 7.
//       dQ += dS K: RS wgmma, bf16 B = the K tile MN-major, chained in
//         the accumulator across tiles; fp32 B = K^T, each tile's product
//         from zero (scale-d 0) in `part`, added to dq in fp32 (the tensor
//         cores round their sums toward zero: a chained sum would drift by
//         an ulp a tile).
//     Software-pipelined as dK/dV: a step issues tile i's S, dP and tile
//     i - 1's dQ product, then computes tile i's P and dS while the dQ
//     product runs, dS in two register buffers that take turns. A
//     consumer whose rows end before the block's last tiles (causal, or
//     past Tq) releases those stages unread. scale is applied at the end;
//     rows past Tq are not stored. Masks are applied only on tiles that
//     cross this warp's diagonal or Tk: TMA fills rows past a tensor with
//     zeros, and a zero key scores 0, not -1e30.
// Registers (`cuobjdump -res-usage`, as phase 1 prints them): bf16 128 a
// thread at launch (two blocks an SM; the consumer 232 after
// setmaxnreg); fp32 156 (D 32), 222 (D 64), 186-188 (D 128); no
// instance has a stack frame or local memory. The resident
// tiles' descriptors are made opaque each tile (an empty asm), or the
// compiler hoists all 4 D / 8 of them out of the loop and D = 128 spills.
//
// Rounding against the plain version: bf16 as dK/dV; fp32 products are
// 3xTF32 (each operand x = hi + lo, both cvt.rna), within about 1e-6 of
// fp32 each, the per-tile sums added in fp32.

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

// acc = A . B from zero for this consumer's 64 rows: A = its rows of
// the K-major tile X of XR rows (dK/dV: K or V; dQ: Q or dO), B = the
// K-major streamed tile Y of BQ rows (dK/dV: Q or dO; dQ: K or V). The
// first product ignores acc (scale-d 0: no instruction but the wgmma
// writes it, which keeps ptxas from serialising the products).
template <int D, int BQ, int XR = kKRows>
__device__ __forceinline__ void issue_first(float (&acc)[BQ / 8][4],
                                            uint64_t X, int c, uint64_t Y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BQ>(acc, desc_k<D>(X, XR, 64 * c, kk),
                 desc_k<D>(Y, BQ, 0, kk), kk > 0);
}

// acc += A . Y (acc = A . Y for the first tile), A from registers
// (dK/dV: P^T or dS^T; dQ: dS), Y (dK/dV: dO or Q; dQ: K) MN-major: one
// RS product a k16 step and DB-column box of Y
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

// ------------------------------------------------------------------ dQ
// The dQ kernel's tiles, by element type T and head dim D: NC consumer
// warpgroups of 64 q rows (BQ = 64 NC rows a block), streamed K/V tiles
// of BK keys in a ring of S stages. Chosen on the card (`chip_smoke.py
// --dq-tiles-trial` builds and times the others; PERF.md, PR 28): in
// bf16 a 64-row block, two blocks an SM, beat a 128-row block of two
// consumers by 6-10% at every main-path shape, and a 192-row block of
// three was 3% faster at the long causal walk but 15% slower at the
// ring's 512-key chunk. One tile ahead (S and dP of tile i + 1 in
// flight during tile i's softmax) was tried in a probe build and
// dropped: it was slower there, and ptxas serialises it unless every
// step's pattern of products in flight is static (C7514, C7515).
//   bf16: 64-key tiles (32 at D = 128, so that 4 stages fit two blocks
//     an SM), 4 stages: 42, 82 and 98 KB at D = 32, 64, 128.
//   fp32: a stage holds six tiles (K, V, their tf32 lo halves, K^T's hi
//     and lo), so the keys a tile and the stages shrink with D to fit
//     227 KB beside the resident Q, dO and their lo halves, one block an
//     SM: D = 32, two consumers (a converted stage serves 128 rows: 21%
//     faster than one), 32 keys, 4 stages, 163 KB; D = 64, one (two
//     would leave room for 2 stages only), 32 keys, 3 stages, 211 KB;
//     D = 128, one, 16 keys, 2 stages, 227 KB.
template <typename T, int D>
struct DqTiles {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int E = sizeof(T);
  static constexpr int NC = F32 && D == 32 ? 2 : 1;
  static constexpr int BQ = 64 * NC;
  static constexpr int BK = D == 128 ? (F32 ? 16 : 32) : (F32 ? 32 : 64);
  static constexpr int S = F32 ? (D == 32 ? 4 : D == 64 ? 3 : 2) : 4;
  static constexpr int THREADS = (NC + 1) * kWG;
  static constexpr int MIN_BLOCKS = F32 ? 1 : 2;  // blocks an SM
  // registers a thread after setmaxnreg (bf16: the producer gives its
  // registers to the consumer, within the 128 a thread of two blocks an
  // SM; 0: none, the fp32 converters keep theirs)
  static constexpr int PRODUCER_REGS = F32 ? 0 : 24;
  static constexpr int CONSUMER_REGS = F32 ? 0 : 232;
  // fp32: the A operands' lo halves (Q's, dO's) from registers, loaded
  // once, instead of shared memory: the S and dP products then read 7
  // of a k8 step's 9 KB of it (32 keys), and shared memory's bandwidth
  // bounds them. D / 2 registers a thread each: at D = 64 only (at D = 32 two
  // consumers share 168 registers a thread; D = 128 has no room).
  static constexpr bool LO_REGS = F32 && D == 64;
  static constexpr int QB = Box<D, E>::bytes(BQ);
  static constexpr int KB = Box<D, E>::bytes(BK);
  static constexpr int TILES = F32 ? 6 : 2;  // tiles a stage
  // the fp32 K^T tile: D rows of BK keys, RB bytes a row (= its swizzle)
  static constexpr int RB = BK * 4;
  // A fragments of one tile's dS: bf16, BK / 16 k16 steps; fp32, BK / 8
  // k8 steps of hi, then BK / 8 of lo
  static constexpr int NF = F32 ? 2 * (BK / 8) : BK / 16;
  static constexpr int smem() {
    return (F32 ? 4 : 2) * QB + S * TILES * KB + 2 * BQ * 4 +
           1024 /* barriers */ + 1024 /* alignment */;
  }
};

struct DqArgs {
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dq;            // [B, Tq, H, D] in the inputs' dtype
  int H, Tq, Tk;
  float scale;
};

// x's tf32 hi and lo (x = hi + lo + O(2^-22 |x|)), as floats
__device__ __forceinline__ void split4(const float4 x, float4& hi,
                                       float4& lo) {
  const Tf32Pair a = split_tf32(x.x), b = split_tf32(x.y),
                 c = split_tf32(x.z), d = split_tf32(x.w);
  hi = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                   __uint_as_float(c.hi), __uint_as_float(d.hi));
  lo = make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                   __uint_as_float(c.lo), __uint_as_float(d.lo));
}

// fp32: the slot of key r of a streamed tile in K^T's rows. A thread
// holds columns 2t, 2t + 1 of an 8-column tile of dS but the tf32 A
// fragment takes k = t, t + 4, so each 8 keys are stored in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (key 2t at slot t, 2t + 1 at slot t + 4)
__device__ __forceinline__ int kt_slot(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// fp32 acc = A . B from zero as 3xTF32 (lo.hi + hi.lo + hi.hi, the small
// terms first): A = consumer c's 64 rows of the BQ-row resident tile (Q
// or dO; hi and lo), B =
// the streamed tile Y of BK rows (K or V; hi and lo), both K-major
template <int D, int BK, int BQ>
__device__ __forceinline__ void issue_first_tf32(float (&acc)[BK / 8][4],
                                                 uint64_t xh, uint64_t xl,
                                                 int c, uint64_t yh,
                                                 uint64_t yl) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ah = desc_k<D, 4>(xh, BQ, 64 * c, kk),
                   al = desc_k<D, 4>(xl, BQ, 64 * c, kk),
                   bh = desc_k<D, 4>(yh, BK, 0, kk),
                   bl = desc_k<D, 4>(yl, BK, 0, kk);
    wgmma_ss_tf32<BK>(acc, al, bh, kk > 0);
    wgmma_ss_tf32<BK>(acc, ah, bl, 1);
    wgmma_ss_tf32<BK>(acc, ah, bh, 1);
  }
}

// issue_first_tf32 with A's lo half from registers (lo[kk]: the m16n8k8
// tf32 A fragment of k8 step kk: an RS product), its hi half from shared
// memory
template <int D, int BK, int BQ>
__device__ __forceinline__ void issue_first_tf32_rlo(
    float (&acc)[BK / 8][4], const uint32_t (&lo)[D / 8][4], uint64_t xh,
    int c, uint64_t yh, uint64_t yl) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ah = desc_k<D, 4>(xh, BQ, 64 * c, kk),
                   bh = desc_k<D, 4>(yh, BK, 0, kk),
                   bl = desc_k<D, 4>(yl, BK, 0, kk);
    wgmma_rs_tf32<BK>(acc, lo[kk], bh, kk > 0);
    wgmma_ss_tf32<BK>(acc, ah, bl, 1);
    wgmma_ss_tf32<BK>(acc, ah, bh, 1);
  }
}

// fp32 part = dS . K from zero as 3xTF32: A = dS's fragments (fr[kk]
// hi, fr[BK / 8 + kk] lo), B = K^T (hi th, lo tl): D rows, K-major, one
// k8 step 32 bytes into the row
template <int D, int BK>
__device__ __forceinline__ void issue_second_tf32(
    float (&part)[D / 8][4], const uint32_t (&fr)[2 * (BK / 8)][4],
    uint64_t th, uint64_t tl) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint64_t bh = th + (uint64_t)(kk * 2), bl = tl + (uint64_t)(kk * 2);
    wgmma_rs_tf32<D>(part, fr[BK / 8 + kk], bh, kk > 0);
    wgmma_rs_tf32<D>(part, fr[kk], bl, 1);
    wgmma_rs_tf32<D>(part, fr[kk], bh, 1);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(DqTiles<T, D>::THREADS,
                                  DqTiles<T, D>::MIN_BLOCKS)
    flash_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                             __grid_constant__ const CUtensorMap tk,
                             __grid_constant__ const CUtensorMap tv,
                             __grid_constant__ const CUtensorMap tdo,
                             DqArgs a) {
  using C = DqTiles<T, D>;
  constexpr bool F32 = C::F32;
  constexpr int BQ = C::BQ, BK = C::BK, S = C::S, NF = C::NF;
  constexpr int QB = C::QB, KB = C::KB, RB = C::RB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  // resident: Q and dO (fp32: rounded to tf32 in place, their lo halves
  // beside); streamed, tile kind k of stage s at st0 + (k S + s) KB:
  // 0 K, 1 V (fp32: rounded in place), 2 K lo, 3 V lo, 4 K^T hi, 5 K^T lo
  T* Qs = reinterpret_cast<T*>(base);
  T* dOs = reinterpret_cast<T*>(base + QB);
  unsigned char* Qlo = base + 2 * QB;
  unsigned char* dOlo = base + 3 * QB;
  unsigned char* st0 = base + (F32 ? 4 : 2) * QB;
  auto tile = [&](int kind, int s) { return st0 + (kind * S + s) * KB; };
  float* lse_s = reinterpret_cast<float*>(st0 + S * C::TILES * KB);
  float* dlt_s = lse_s + BQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(dlt_s + BQ);
  uint64_t* q_conv = q_full + 1;
  uint64_t* full = q_full + 2;  // [S]: a stage's K and V landed
  uint64_t* conv = full + S;    // [S]: fp32, its hi, lo and K^T written
  uint64_t* empty = conv + S;   // [S]: the consumers are done with it

  // tiles are the slowest grid axis; with causal masking the heaviest q
  // tiles (the last) are handed out first
  const int qt = CAUSAL ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, hh = blockIdx.x, bb = blockIdx.y;
  const long long row0 = ((long long)bb * a.H + hh) * a.Tq;
  const int n_k = (a.Tk + BK - 1) / BK;
  // k tiles the block walks: causal, none past its last row's diagonal
  const int last_q = min(q0 + BQ, a.Tq) - 1;
  const int nt = CAUSAL ? min(n_k, last_q / BK + 1) : n_k;

  if (threadIdx.x == 0) {
    prefetch_tma(&tq);
    prefetch_tma(&tk);
    prefetch_tma(&tv);
    prefetch_tma(&tdo);
    mbar_init(q_full, 32);  // the producer warp's lanes
    mbar_init(q_conv, 3 * 32);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&conv[s], 3 * 32);
      mbar_init(&empty[s], C::NC * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {  // ---------------------------------------- producer
    if constexpr (C::PRODUCER_REGS > 0) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      // warp 0: the block's lse (log2 units) and delta rows, Q and dO
      // once, then the K/V ring (lane 0)
      const int lane = threadIdx.x;
#pragma unroll
      for (int h = 0; h < BQ / 32; ++h) {
        const int q = q0 + h * 32 + lane;
        const bool in = q < a.Tq;
        lse_s[h * 32 + lane] = in ? a.lse[row0 + q] * kLog2e : 0.f;
        dlt_s[h * 32 + lane] = in ? a.delta[row0 + q] : 0.f;
      }
      if (lane != 0) {
        mbar_arrive(q_full);
        return;
      }
      mbar_expect_tx(q_full, 2 * QB);
      tma_load_rows<D>(Qs, &tq, q_full, BQ, hh, q0, bb);
      tma_load_rows<D>(dOs, &tdo, q_full, BQ, hh, q0, bb);
      for (int i = 0; i < nt; ++i) {
        const int st = i % S;
        mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * KB);
        tma_load_rows<D>(reinterpret_cast<T*>(tile(0, st)), &tk, &full[st],
                         BK, hh, i * BK, bb);
        tma_load_rows<D>(reinterpret_cast<T*>(tile(1, st)), &tv, &full[st],
                         BK, hh, i * BK, bb);
      }
    } else if constexpr (F32) {
      // warps 1-3 (fp32): the tf32 hi and lo halves of every operand,
      // and K^T for dS K (tf32 wgmma reads its shared-memory operands
      // K-major only)
      const int ct = threadIdx.x - 32;
      mbar_wait(q_full, 0);
      // Q and dO: rounded in place, lo beside
      auto split_tile = [&](void* x, void* lo) {
        float4* xs = reinterpret_cast<float4*>(x);
        float4* ls = reinterpret_cast<float4*>(lo);
        for (int f = ct; f < QB / 16; f += 3 * 32) {
          float4 h, l;
          split4(xs[f], h, l);
          xs[f] = h;
          ls[f] = l;
        }
      };
      split_tile(Qs, Qlo);
      split_tile(dOs, dOlo);
      fence_proxy_async();
      mbar_arrive(q_conv);
      for (int i = 0; i < nt; ++i) {
        const int st = i % S;
        mbar_wait(&full[st], (i / S) & 1);
        unsigned char* Kt = tile(0, st);
        unsigned char* Vt = tile(1, st);
        unsigned char* Kl = tile(2, st);
        unsigned char* Vl = tile(3, st);
        float* Th = reinterpret_cast<float*>(tile(4, st));
        float* Tl = reinterpret_cast<float*>(tile(5, st));
        // 16-byte chunk cc (columns 4 cc..4 cc + 3) of key r: a warp's
        // lanes take consecutive keys, so the swizzled reads and K^T's
        // row writes fall on distinct banks
        for (int f = ct; f < BK * D / 4; f += 3 * 32) {
          const int r = f % BK, cc = f / BK;
          const int off =
              (cc / 8) * BK * 128 + r * 128 + (((cc % 8) ^ (r % 8)) << 4);
          float4 kh, kl, vh, vl;
          split4(*reinterpret_cast<const float4*>(Kt + off), kh, kl);
          split4(*reinterpret_cast<const float4*>(Vt + off), vh, vl);
          *reinterpret_cast<float4*>(Kt + off) = kh;
          *reinterpret_cast<float4*>(Kl + off) = kl;
          *reinterpret_cast<float4*>(Vt + off) = vh;
          *reinterpret_cast<float4*>(Vl + off) = vl;
          const int slot = kt_slot(r);
          const float h4[4] = {kh.x, kh.y, kh.z, kh.w};
          const float l4[4] = {kl.x, kl.y, kl.z, kl.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = 4 * cc + j;
            const int sw = RB == 128 ? d % 8 : (d / 2) % 4;
            const int o = d * (RB / 4) + ((((slot >> 2) ^ sw) << 2) |
                                          (slot & 3));
            Th[o] = h4[j];
            Tl[o] = l4[j];
          }
        }
        fence_proxy_async();
        mbar_arrive(&conv[st]);
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  // Software-pipelined as dK/dV: in one step a consumer issues S and dP
  // of k tile i and the dQ product of tile i - 1 together, then computes
  // tile i's P and dS while those run.
  if constexpr (C::CONSUMER_REGS > 0) setmaxnreg_inc<C::CONSUMER_REGS>();
  const int c = C::NC == 1 ? 0 : wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int rw = q0 + 64 * c + 16 * warp;  // this warp's first q row
  const int r[2] = {rw + (lane >> 2), rw + (lane >> 2) + 8};  // this thread's
  // k tiles this consumer's rows reach (none when they all lie past Tq)
  const int c_last = min(q0 + 64 * c + 64, a.Tq) - 1;
  const int ntc = q0 + 64 * c >= a.Tq ? 0
                  : CAUSAL            ? min(n_k, c_last / BK + 1)
                                      : n_k;
  // the barrier a stage is ready on: landed (bf16), converted (fp32)
  uint64_t* ready = F32 ? conv : full;
  const float sl2 = a.scale * kLog2e;

  mbar_wait(q_full, 0);
  if constexpr (F32) mbar_wait(q_conv, 0);
  // C::LO_REGS: Q's and dO's lo halves as A fragments, loaded once (the
  // arrays are empty otherwise: one row, never read)
  uint32_t qlo[C::LO_REGS ? D / 8 : 1][4], olo[C::LO_REGS ? D / 8 : 1][4];
  if constexpr (C::LO_REGS) {
    auto frag = [&](const unsigned char* x, uint32_t (&f)[D / 8][4]) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = 64 * c + 16 * warp + (lane >> 2) + (j & 1) * 8;
          const int col = 8 * kk + t + (j >> 1) * 4, kc = col % 32;
          const int off = (col / 32) * BQ * 128 + row * 128 +
                          (((kc / 4) ^ (row % 8)) << 4) + (kc % 4) * 4;
          f[kk][j] = *reinterpret_cast<const uint32_t*>(x + off);
        }
    };
    frag(Qlo, qlo);
    frag(dOlo, olo);
  }
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[r[i] - q0];
    dlt[i] = dlt_s[r[i] - q0];
  }

  // P = 2^(S scale log2e - lse log2e) and dS = P (dP - delta) of k tile
  // i (scores masked with -1e30 only where the tile crosses this warp's
  // diagonal or Tk), into the A fragments fr of the dQ product: bf16,
  // rounded and packed (k16 step kk is the accumulator's 8-column tiles
  // 2 kk and 2 kk + 1); fp32, tf32 hi and lo (k8 step n is tile n, its
  // columns 2t, 2t + 1 as k = t, t + 4)
  auto elementwise = [&](float (&s)[BK / 8][4], float (&dp)[BK / 8][4],
                         int i, uint32_t (&fr)[NF][4]) {
    const int k0 = i * BK;
    if (k0 + BK > a.Tk || (CAUSAL && k0 + BK - 1 > rw)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * t + (e & 1), qpos = r[e >> 1];
          if (!(kpos < a.Tk && (!CAUSAL || kpos <= qpos))) s[n][e] = kNegInf;
        }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], sl2, -lse2[e >> 1]));
        dp[n][e] = p * (dp[n][e] - dlt[e >> 1]);  // ds
      }
    if constexpr (F32) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float x[4] = {dp[n][0], dp[n][2], dp[n][1], dp[n][3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Tf32Pair h = split_tf32(x[j]);
          fr[n][j] = h.hi;
          fr[BK / 8 + n][j] = h.lo;
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 2 * kk + (j >> 1), e = 2 * (j & 1);
          fr[kk][j] = pack_bf16(dp[n][e], dp[n][e + 1]);
        }
    }
  };

  // S and dP of k tile i (stage st), issued
  auto issue_sdp = [&](float (&s)[BK / 8][4], float (&dp)[BK / 8][4],
                       int st) {
    if constexpr (F32) {
      // the resident tiles' descriptors, made opaque each tile: left to
      // itself the compiler hoists their 4 D / 8 k-step descriptors out
      // of the loop, 64-bit each, and at D = 128 spills
      uint64_t qh = tile_desc<D, 4>(Qs), ql = tile_desc<D, 4>(Qlo),
               oh = tile_desc<D, 4>(dOs), ol = tile_desc<D, 4>(dOlo);
      asm volatile("" : "+l"(qh), "+l"(ql), "+l"(oh), "+l"(ol));
      if constexpr (C::LO_REGS) {
        issue_first_tf32_rlo<D, BK, BQ>(s, qlo, qh, c,
                                        tile_desc<D, 4>(tile(0, st)),
                                        tile_desc<D, 4>(tile(2, st)));
        issue_first_tf32_rlo<D, BK, BQ>(dp, olo, oh, c,
                                        tile_desc<D, 4>(tile(1, st)),
                                        tile_desc<D, 4>(tile(3, st)));
      } else {
        issue_first_tf32<D, BK, BQ>(s, qh, ql, c,
                                    tile_desc<D, 4>(tile(0, st)),
                                    tile_desc<D, 4>(tile(2, st)));
        issue_first_tf32<D, BK, BQ>(dp, oh, ol, c,
                                    tile_desc<D, 4>(tile(1, st)),
                                    tile_desc<D, 4>(tile(3, st)));
      }
    } else {
      issue_first<D, BK, BQ>(s, tile_desc<D>(Qs), c,
                             tile_desc<D>(tile(0, st)));
      issue_first<D, BK, BQ>(dp, tile_desc<D>(dOs), c,
                             tile_desc<D>(tile(1, st)));
    }
  };

  // dQ: bf16, chained through the accumulator across tiles (the first
  // tile's from zero); fp32, each tile's product from zero into `part`,
  // added to dq in fp32 once it is in (the tensor cores round their
  // sums toward zero, a chained sum would drift an ulp a tile)
  float dq[D / 8][4], part[D / 8][4];
  if constexpr (F32) zero(dq);
  auto issue_dq = [&](const uint32_t (&fr)[NF][4], int pst, bool first) {
    if constexpr (F32)
      issue_second_tf32<D, BK>(part, fr,
                               make_desc(tile(4, pst), 16, 8 * RB, RB),
                               make_desc(tile(5, pst), 16, 8 * RB, RB));
    else
      issue_second<D, BK>(dq, fr, tile_desc<D>(tile(0, pst)), first);
  };
  auto dq_in = [&]() {
    if constexpr (F32) {
      fence_regs(part);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] += part[n][e];
    } else {
      fence_regs(dq);
    }
  };

  // dS of a tile waiting for its dQ product, in two buffers that take
  // turns (no register copy between a product's issue and its wait)
  uint32_t fr0[NF][4], fr1[NF][4];
  // k tile i's S, dP and tile i - 1's dQ products (from fr_in) issued
  // together; tile i's dS into fr_out while those run
  auto step = [&](int i, uint32_t(&fr_in)[NF][4], uint32_t(&fr_out)[NF][4]) {
    const int st = i % S, pst = (i - 1) % S;
    float s[BK / 8][4], dp[BK / 8][4];
    mbar_wait(&ready[st], (i / S) & 1);
    wgmma_fence();
    issue_sdp(s, dp, st);
    wgmma_commit();
    issue_dq(fr_in, pst, i == 1);
    wgmma_commit();
    wgmma_wait<1>();  // S and dP are in
    fence_regs(s);
    fence_regs(dp);
    elementwise(s, dp, i, fr_out);
    // done before the wait below, so it runs while the dQ product does
    fence_regs(fr_out);
    wgmma_wait<0>();  // dQ of the previous tile is in
    dq_in();
    // fr_in stays live to here, so fr_out never takes its registers
    // while the product still reads them
    fence_regs(fr_in);
    mbar_arrive(&empty[pst]);  // this thread is done with that stage
  };
  // the last tile's dQ product (from fr_in)
  auto last = [&](uint32_t(&fr_in)[NF][4]) {
    const int pst = (ntc - 1) % S;
    wgmma_fence();
    issue_dq(fr_in, pst, ntc == 1);
    wgmma_commit();
    wgmma_wait<0>();
    dq_in();
    fence_regs(fr_in);
    mbar_arrive(&empty[pst]);
  };

  if (ntc > 0) {
    {  // k tile 0: the first products alone
      float s[BK / 8][4], dp[BK / 8][4];
      mbar_wait(&ready[0], 0);
      wgmma_fence();
      issue_sdp(s, dp, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      elementwise(s, dp, 0, fr0);
    }
    int i = 1;
    for (; i + 1 < ntc; i += 2) {
      step(i, fr0, fr1);
      step(i + 1, fr1, fr0);
    }
    if (i < ntc) {
      step(i, fr0, fr1);
      last(fr1);
    } else {
      last(fr0);
    }
  }
  // the block's tiles past this consumer's rows (its diagonal, or Tq):
  // released unread once they are in, so the ring's phases stay counted
  for (int i = ntc; i < nt; ++i) {
    mbar_wait(&ready[i % S], (i / S) & 1);
    mbar_arrive(&empty[i % S]);
  }
  if (ntc == 0) return;

  T* dqp = reinterpret_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= a.Tq) continue;
    T* row = dqp + (((long long)bb * a.Tq + r[i]) * a.H + hh) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(row + n * 8, dq[n][2 * i] * a.scale,
                dq[n][2 * i + 1] * a.scale);
  }
}

template <typename T, int D, bool CAUSAL>
int launch_dq(const CUtensorMap (&maps)[4], const DqArgs& a, int B,
              cudaStream_t stream) {
  using C = DqTiles<T, D>;
  auto kern = flash_bwd_dq_sm90_kernel<T, D, CAUSAL>;
  constexpr int smem = C::smem();
  static_assert(smem <= 232448, "a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B, (a.Tq + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                           a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq_by_causal(int causal, const void* const (&ptrs)[4], const long long* L,
                 const DqArgs& a, int B, cudaStream_t s) {
  using C = DqTiles<T, D>;
  constexpr int E = C::E;
  // q's and dO's maps load BQ-row tiles of Tq rows, k's and v's BK-row
  // tiles of Tk rows, all of E-byte elements
  if (!layout_is<D, E>(L, B, a.Tq, a.H, C::BQ) ||
      !layout_is<D, E>(L + 12, B, a.Tk, a.H, C::BK) ||
      !layout_is<D, E>(L + 24, B, a.Tk, a.H, C::BK) ||
      !layout_is<D, E>(L + 36, B, a.Tq, a.H, C::BQ))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int err = encode_tma(&maps[i], ptrs[i], L + 12 * i, E);
    if (err) return err;
  }
  return causal ? launch_dq<T, D, true>(maps, a, B, s)
                : launch_dq<T, D, false>(maps, a, B, s);
}

template <typename T>
int dq_by_d(int D, int causal, const void* const (&ptrs)[4],
            const long long* L, const DqArgs& a, int B, cudaStream_t s) {
  switch (D) {
    case 32: return dq_by_causal<T, 32>(causal, ptrs, L, a, B, s);
    case 64: return dq_by_causal<T, 64>(causal, ptrs, L, a, B, s);
    case 128: return dq_by_causal<T, 128>(causal, ptrs, L, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// q/dout [B, Tq, H, D] and k/v [B, Tk, H, D] in bf16 (dtype code 1) or
// fp32 (code 0), described by `maps`: 12 numbers each for q, k, v, dout,
// as `_tma_layout` works them out for DqTiles' rows (`DQ_Q_ROWS`,
// `DQ_KV_ROWS` in kernels/flash_attention.py). lse and delta are
// contiguous [B, H, Tq] fp32; dq contiguous [B, Tq, H, D] in the inputs'
// dtype. D must be 32, 64 or 128. Returns cudaGetLastError() after the
// launch, or the error that kept it from launching.
extern "C" int dl4j_flash_attention_bwd_dq_sm90(
    int dtype, int causal, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq, int B,
    int Tq, int Tk, int H, int D, const long long* maps, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return 0;
  dl4j::DqArgs a{};
  a.lse = lse; a.delta = delta; a.dq = dq;
  a.H = H; a.Tq = Tq; a.Tk = Tk; a.scale = scale;
  const void* const ptrs[4] = {q, k, v, dout};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case dl4j::kBF16:
      return dl4j::dq_by_d<__nv_bfloat16>(D, causal, ptrs, maps, a, B, s);
    case dl4j::kF32:
      return dl4j::dq_by_d<float>(D, causal, ptrs, maps, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
