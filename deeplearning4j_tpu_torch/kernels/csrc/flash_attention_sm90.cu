// Flash-attention forward for Hopper (sm_90a), bf16, in its two modes:
// warp-specialised, TMA-fed, on wgmma. The fp32 instances stay the
// 3xTF32 mma.sync kernel of csrc/flash_attention.cu.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:87) for bf16 inputs:
// - finalize (`flash_attention` -> `_flash_forward`, pallas_call :200):
//   o = softmax(q k^T / sqrt(D)) v with the online softmax in fp32, the
//   causal mask k_pos <= q_pos and the ragged key tail masked with -1e30
//   (the JAX kernel's value), lse = m + log(l); emits o [B, Tq, H, D] in
//   bf16 and lse [B, H, Tq] in fp32.
// - carry (`flash_attention_carry` :245): folds one K/V chunk into the
//   fp32 state m, l [B, H, Tq] and acc [B, H, Tq, D], IN PLACE (each
//   thread reads its own rows' state before its first tile and writes it
//   after its last). A first fold from m = -1e30 gives corr = 0.
//
// Bound: 4 D FLOPs per visible (q, k) pair against 4 reads/writes of a
// [B, T, H, D] bf16 tensor (carry: plus a read and a write of the state).
// At [8, 2048, 8, 64] causal: 34.4 GFLOP, 34.8 us at 989 TFLOP/s, against
// 20.2 us of bytes (67.6 MB at 3.35 TB/s): the operations bound it. At
// [16, 512, 8, 32] causal the bytes do (5.1 us against 2.2 us).
//
// Design (FlashAttention-3's shape): a persistent grid, one block an SM,
// each walking work items (128-row q tile, head, batch); with causal
// masking the last q tiles walk the most K/V tiles, so items go heaviest
// first, dealt to the blocks in zig-zag rounds (`work_item`). 3
// warpgroups a block:
//   producer (warpgroup 0, gives its registers away: setmaxnreg 24): one
//     thread loads each item's Q tile by TMA into one of two buffers and
//     streams K/V tiles (128 keys; 64 at D = 128 and in carry mode)
//     through a 4-stage ring,
//     each stage guarded by full barriers (K and V apart, so S starts
//     before V lands) and empty barriers that every consumer thread
//     arrives on: K's once its S is in, V's once its P V is. The ring
//     runs on across items, so the next item's tiles load while the
//     consumers finish this one and write its rows out.
//   consumers (warpgroups 1, 2; setmaxnreg 240), each owning 64 q rows,
//   software-pipelined: in one step a consumer issues S of tile kt and
//   P V of tile kt - 1, then computes tile kt's softmax while that P V
//   runs. The two consumers issue independently (FlashAttention-3's
//   ping-pong over named barriers bought nothing measurable here;
//   PERF.md).
//     S = Q K^T: SS wgmma m64n{BN}k16, Q and K K-major in shared memory,
//       D / 16 steps, the first with scale-d 0 (fresh accumulators).
//     the online softmax in registers (a thread holds two rows): the row
//       max on the raw scores, P = 2^(s scale log2e - m) by one FFMA and
//       ex2.approx, -1e30 masks only where this warp's 16 rows cross the
//       diagonal or the tile crosses the ragged key tail.
//     P V: RS wgmma m64n{DB}k16, A = P converted in registers from S's
//       accumulator layout to bf16 A fragments (never in shared memory),
//       B = V MN-major from shared memory, one product per DB-column box
//       of V. Carry keeps P as bf16 hi + lo, two products into the same
//       sum, the small terms first (a single bf16 P misses the carry's
//       2e-5 bound by about 100x). P sits in two register buffers that
//       take turns, so no instruction writes a fragment an in-flight
//       wgmma reads (ptxas would serialise the products otherwise).
//   The tensor cores round their fp32 sums toward zero, so each tile's
//   P V is summed from zero in fresh accumulators and added to acc * corr
//   by one FFMA; acc is never chained through the wgmma.
// Tiles are 1024-byte aligned and swizzled by the TMA (64B at D = 32,
// 128B otherwise; csrc/hopper.cuh). Rows past Tq/Tk land as zeros; a
// zero key scores 0, not -1e30, so the k_pos < Tk mask stays.
// Shared memory a block: 2 Q tiles, 4 K and 4 V tiles and 2 KB: 82 KB at
// D = 32, 162 KB at D = 64, 194 KB at D = 128 (carry: 50 KB at D = 32,
// 98 KB at D = 64). 384 threads at the 168 registers the launch bound
// leaves (consumers 240 after setmaxnreg); no instance spills or has its
// products serialised (chip_smoke.py phase 1).
//
// Rounding against the plain version (fp32 einsums of the same inputs):
// S is exact bf16 products summed in fp32; P is rounded to bf16 before
// P V (finalize; as FlashAttention-2/3) or split into hi + lo (carry, about
// 2^-17 a term). Sums run in another order than the plain einsums.

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace dl4j {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kThreads = 3 * kWG;  // producer + two consumers
constexpr int kQRows = 128;        // q rows a block, 64 a consumer
constexpr int kStages = 4;

// keys a streamed tile: 128, or 64 where the registers a consumer keeps
// for two tiles at once (S of one, P and P V of the previous) would not
// fit otherwise: at D = 128, and in carry mode, whose P is a hi + lo
// pair in two buffers (at 128 keys and D = 64 ptxas serialises the
// products for want of registers, warning C7512)
template <int D, bool CARRY>
__host__ __device__ constexpr int kv_rows() {
  return D == 128 || CARRY ? 64 : 128;
}

struct FwdArgs {
  void* o;     // finalize: [B, Tq, H, D] bf16
  float* lse;  // finalize: [B, H, Tq]
  float* m;    // carry: [B, H, Tq], read and written in place
  float* l;    // carry: [B, H, Tq]
  float* acc;  // carry: [B, H, Tq, D]
  int B, H, Tq, Tk;
  float scale;
};

template <int D, bool CARRY>
constexpr int fwd_smem_bytes() {
  return 2 * Box<D>::bytes(kQRows) +
         2 * kStages * Box<D>::bytes(kv_rows<D, CARRY>()) +
         1024 /* barriers */ +
         1024 /* alignment */;
}

// S = Q K^T for this consumer's 64 rows: D / 16 SS products, the first
// into fresh accumulators (scale-d 0: no instruction but the wgmma
// writes them, which keeps ptxas from serialising the products)
template <int D, int BN>
__device__ __forceinline__ void issue_s(float (&s)[BN / 8][4], uint64_t Qd,
                                        int c, uint64_t Kd) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BN>(s, desc_k<D>(Qd, kQRows, 64 * c, kk),
                 desc_k<D>(Kd, BN, 0, kk), kk > 0);
}

// part = P V from zero, one RS product a k16 step and DB-column box of
// V; with P as hi + lo (NS = 2) the small terms' product goes first
// into the sum
template <int D, int BN, int NS>
__device__ __forceinline__ void issue_pv(float (&part)[D / 8][4],
                                         const uint32_t (&p)[NS][BN / 16][4],
                                         uint64_t Vd) {
  using L = Box<D>;
#pragma unroll
  for (int j = 0; j < L::NB; ++j) {
    auto& pj = *reinterpret_cast<float(*)[L::DB / 8][4]>(part[j * L::DB / 8]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = desc_mn<D>(Vd, BN, j, kk);
      if constexpr (NS == 2) wgmma_rs<L::DB>(pj, p[1][kk], dv, kk > 0);
      wgmma_rs<L::DB>(pj, p[0][kk], dv, NS == 2 || kk > 0);
    }
  }
}

// The online softmax of one tile of S (this thread's rows r[0], r[1],
// keys k0..): masks with -1e30 only where this warp's rows `rw`.. cross
// the diagonal or the tile crosses Tk; the row max on the raw scores
// (scale > 0), the new max m2 in log2 units, corr = 2^(m_old - m_new),
// P = 2^(s scale log2e - m2) (one FFMA and one ex2 a score), l = l corr
// + row sum; P rounded to bf16 (or split into hi + lo, NS = 2) as the A
// fragments of the second product: k16 step kk is the accumulator's
// 8-column tiles 2 kk and 2 kk + 1
template <int BN, int NS, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BN / 8][4], float (&m2)[2], float (&l)[2], float (&corr)[2],
    uint32_t (&p)[NS][BN / 16][4], int k0, int Tk, int rw,
    const int (&r)[2], int t, float sl2) {
  if (k0 + BN > Tk || (CAUSAL && k0 + BN - 1 > rw)) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        if (!(kpos < Tk && (!CAUSAL || kpos <= r[e >> 1])))
          s[n][e] = kNegInf;
      }
  }
  // row max and sum over 4 partials a row (short dependency chains)
  float mp[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) mp[0][e] = mp[1][e] = kNegInf;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, j = (n & 1) * 2 + (e & 1);
      mp[i][j] = fmaxf(mp[i][j], s[n][e]);
    }
  float mx[2], rs[2], neg[2], sp[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(fmaxf(mp[i][0], mp[i][1]), fmaxf(mp[i][2], mp[i][3]));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m2[i], mx[i] * sl2);
    corr[i] = ex2(m2[i] - m_new);
    m2[i] = m_new;
    neg[i] = -m_new;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) sp[0][e] = sp[1][e] = 0.f;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(s[n][e], sl2, neg[e >> 1]));
      s[n][e] = x;
      sp[e >> 1][(n & 1) * 2 + (e & 1)] += x;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] = (sp[i][0] + sp[i][1]) + (sp[i][2] + sp[i][3]);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * corr[i] + rs[i];
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a0: row g, k 2t..; a1: row g+8; a2, a3: k 2t+8.. (the next tile)
      const float* x = s[2 * kk + (i >> 1)] + 2 * (i & 1);
      if constexpr (NS == 2) {
        const Bf16Pair sp = split_bf16(x[0], x[1]);
        p[0][kk][i] = sp.hi;
        p[1][kk][i] = sp.lo;
      } else {
        p[0][kk][i] = pack_bf16(x[0], x[1]);
      }
    }
}

// acc = acc * corr + part in fp32 (one rounding, to nearest)
template <int D>
__device__ __forceinline__ void fold(float (&acc)[D / 8][4],
                                     const float (&corr)[2],
                                     const float (&part)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = fmaf(acc[n][e], corr[e >> 1], part[n][e]);
}

// Finalize: o, lse are written, the state pointers are unused. Carry:
// m, l [B, H, Tq] and acc [B, H, Tq, D] (contiguous fp32) are read as the
// seed and overwritten with the folded state; o, lse unused.
template <int D, bool CAUSAL, bool CARRY>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          FwdArgs a) {
  using L = Box<D>;
  constexpr int BN = kv_rows<D, CARRY>(), NS = CARRY ? 2 : 1;
  constexpr int QB = L::bytes(kQRows), KB = L::bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [2] tiles
  bf16* Ks = reinterpret_cast<bf16*>(base + 2 * QB);  // [kStages] tiles
  bf16* Vs = reinterpret_cast<bf16*>(base + 2 * QB + kStages * KB);
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(base + 2 * QB + 2 * kStages * KB);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int n_qt = (a.Tq + kQRows - 1) / kQRows, HB = a.H * a.B;
  const int n_items = n_qt * HB;
  // item j: its first q row, head, batch and K/V tile count
  auto item = [&](int j, int& q0, int& hh, int& bb, int& n_k) {
    const int qt = j / HB, bh = j % HB;
    q0 = (CAUSAL ? n_qt - 1 - qt : qt) * kQRows;
    hh = bh % a.H;
    bb = bh / a.H;
    n_k = (a.Tk + BN - 1) / BN;
    if (CAUSAL) {
      const int last = (q0 + kQRows - 1) / BN;  // tiles past it skip
      n_k = n_k < last + 1 ? n_k : last + 1;
    }
  };

  if (threadIdx.x == 0) {
    prefetch_tma(&tq);
    prefetch_tma(&tk);
    prefetch_tma(&tv);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 2 * kWG);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2 * kWG);
      mbar_init(&v_empty[s], 2 * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {  // ---------------------------------------- producer
    // Q tiles in two buffers, K/V tiles through the ring; `it` counts
    // K/V tiles over the block's items, so the ring runs on from one
    // item into the next while the consumers finish the last
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0; work_item(r) < n_items; ++r) {
        int q0, hh, bb, n_k;
        item(work_item(r), q0, hh, bb, n_k);
        const int qb = r & 1;
        mbar_wait(&q_empty[qb], ((r >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], QB);
        tma_load_rows<D>(Qs + qb * kQRows * D, &tq, &q_full[qb], kQRows, hh,
                         q0, bb);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kStages;
          const uint32_t free = ((it / kStages) & 1) ^ 1;
          mbar_wait(&k_empty[st], free);
          mbar_expect_tx(&k_full[st], KB);
          tma_load_rows<D>(Ks + st * BN * D, &tk, &k_full[st], BN, hh,
                           kt * BN, bb);
          mbar_wait(&v_empty[st], free);
          mbar_expect_tx(&v_full[st], KB);
          tma_load_rows<D>(Vs + st * BN * D, &tv, &v_full[st], BN, hh,
                           kt * BN, bb);
        }
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  // Software-pipelined as FlashAttention-3: in one step a consumer
  // issues S of tile kt and P V of tile kt - 1 together, then computes
  // tile kt's softmax while that P V runs, and folds its sum into acc.
  setmaxnreg_inc<240>();
  const int c = wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const float sl2 = a.scale * kLog2e;

  int it = 0;
  for (int r = 0; work_item(r) < n_items; ++r) {
    int q0, hh, bb, n_k;
    item(work_item(r), q0, hh, bb, n_k);
    const int qb = r & 1;
    const int rw = q0 + 64 * c + 16 * warp;  // this warp's first q row
    const int rr[2] = {rw + (lane >> 2), rw + (lane >> 2) + 8};  // thread's
    // row (b, h, t) of the [B, H, Tq] state / lse layout is row0 + t
    const long long row0 = ((long long)bb * a.H + hh) * a.Tq;

    float m2[2], l[2], acc[D / 8][4];  // m in log2 units
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool seed = CARRY && rr[i] < a.Tq;
      m2[i] = seed ? a.m[row0 + rr[i]] * kLog2e : kNegInf;
      l[i] = seed ? a.l[row0 + rr[i]] : 0.f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float2 v2 = make_float2(0.f, 0.f);
        if (seed)
          v2 = *reinterpret_cast<const float2*>(a.acc + (row0 + rr[i]) * D +
                                                n * 8 + 2 * t);
        acc[n][2 * i] = v2.x;
        acc[n][2 * i + 1] = v2.y;
      }
    }

    // P of a tile waiting for its product with V, and the correction
    // that goes with it, in two buffers that take turns (no register
    // copy between a product's issue and its wait)
    uint32_t pa[NS][BN / 16][4], pb[NS][BN / 16][4];
    float ca[2], cb[2];
    const uint64_t Qd = tile_desc<D>(Qs + qb * kQRows * D);
    mbar_wait(&q_full[qb], (r >> 1) & 1);
    {  // tile 0: S alone
      const int st = it % kStages;
      float s[BN / 8][4];
      mbar_wait(&k_full[st], (it / kStages) & 1);
      wgmma_fence();
      issue_s<D, BN>(s, Qd, c, tile_desc<D>(Ks + st * BN * D));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&k_empty[st]);
      softmax_tile<BN, NS, CAUSAL>(s, m2, l, ca, pa, 0, a.Tk, rw, rr, t,
                                   sl2);
    }
    // tile kt's S and tile kt - 1's P V (from p_in) issued together; tile
    // kt's softmax into p_out while that P V runs; then acc = acc c_in +
    // P V
    auto step = [&](int kt, uint32_t(&p_in)[NS][BN / 16][4],
                    const float(&c_in)[2], uint32_t(&p_out)[NS][BN / 16][4],
                    float(&c_out)[2]) {
      const int i = it + kt, st = i % kStages, pst = (i - 1) % kStages;
      float s[BN / 8][4], part[D / 8][4];
      mbar_wait(&k_full[st], (i / kStages) & 1);
      mbar_wait(&v_full[pst], ((i - 1) / kStages) & 1);
      wgmma_fence();
      issue_s<D, BN>(s, Qd, c, tile_desc<D>(Ks + st * BN * D));
      wgmma_commit();
      issue_pv<D, BN, NS>(part, p_in, tile_desc<D>(Vs + pst * BN * D));
      wgmma_commit();
      wgmma_wait<1>();  // S is in
      fence_regs(s);
      mbar_arrive(&k_empty[st]);
      softmax_tile<BN, NS, CAUSAL>(s, m2, l, c_out, p_out, kt * BN, a.Tk,
                                   rw, rr, t, sl2);
      // the softmax is done before the wait below (the compiler may move
      // register arithmetic across an asm statement, not asm statements
      // across each other), so it runs while P V does
#pragma unroll
      for (int j = 0; j < NS; ++j) fence_regs(p_out[j]);
      wgmma_wait<0>();  // the previous tile's P V is in
      fence_regs(part);
      // p_in stays live to here, so p_out never takes its registers
      // while P V still reads them (ptxas would wait for P V first)
#pragma unroll
      for (int j = 0; j < NS; ++j) fence_regs(p_in[j]);
      mbar_arrive(&v_empty[pst]);
      fold<D>(acc, c_in, part);
    };
    // the last tile's P V (from p_in)
    auto last = [&](const uint32_t(&p_in)[NS][BN / 16][4],
                    const float(&c_in)[2]) {
      const int i = it + n_k - 1, pst = i % kStages;
      float part[D / 8][4];
      mbar_wait(&v_full[pst], (i / kStages) & 1);
      wgmma_fence();
      issue_pv<D, BN, NS>(part, p_in, tile_desc<D>(Vs + pst * BN * D));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      mbar_arrive(&v_empty[pst]);
      fold<D>(acc, c_in, part);
    };
    int kt = 1;
    for (; kt + 1 < n_k; kt += 2) {
      step(kt, pa, ca, pb, cb);
      step(kt + 1, pb, cb, pa, ca);
    }
    if (kt < n_k) {
      step(kt, pa, ca, pb, cb);
      last(pb, cb);
    } else {
      last(pa, ca);
    }
    mbar_arrive(&q_empty[qb]);  // every product of this item is in
    it += n_k;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rr[i] >= a.Tq) continue;
      if (CARRY) {
        float* row = a.acc + (row0 + rr[i]) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(row + n * 8) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        if (t == 0) {
          a.m[row0 + rr[i]] = m2[i] * kLn2;
          a.l[row0 + rr[i]] = l[i];
        }
        continue;
      }
      const float ls = fmaxf(l[i], 1e-20f), inv = 1.f / ls;
      bf16* row = (bf16*)a.o +
                  (((long long)bb * a.Tq + rr[i]) * a.H + hh) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2<bf16>(row + n * 8, acc[n][2 * i] * inv,
                     acc[n][2 * i + 1] * inv);
      if (t == 0) a.lse[row0 + rr[i]] = m2[i] * kLn2 + logf(ls);
    }
  }
}

// Persistent: one block an SM (at most one a work item) walks its items.
template <int D, bool CAUSAL, bool CARRY>
int launch(const CUtensorMap (&maps)[3], const FwdArgs& a, int B,
           cudaStream_t stream) {
  auto kern = flash_fwd_sm90_kernel<D, CAUSAL, CARRY>;
  constexpr int smem = fwd_smem_bytes<D, CARRY>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long items =
      (long long)((a.Tq + kQRows - 1) / kQRows) * a.H * B;
  const int blocks = (int)(items < sms ? items : sms);
  kern<<<blocks, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

template <int D, bool CARRY>
int by_causal(int causal, const void* const (&ptrs)[3], const long long* L,
              const FwdArgs& a, int B, cudaStream_t s) {
  // q's map loads 128-row tiles of Tq rows, k's and v's
  // kv_rows<D, CARRY>()-row tiles of Tk rows
  if (!layout_is<D>(L, B, a.Tq, a.H, kQRows) ||
      !layout_is<D>(L + 12, B, a.Tk, a.H, kv_rows<D, CARRY>()) ||
      !layout_is<D>(L + 24, B, a.Tk, a.H, kv_rows<D, CARRY>()))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const int err = encode_tma(&maps[i], ptrs[i], L + 12 * i);
    if (err) return err;
  }
  return causal ? launch<D, true, CARRY>(maps, a, B, s)
                : launch<D, false, CARRY>(maps, a, B, s);
}

template <bool CARRY>
int run(int dtype, int causal, const void* const (&ptrs)[3],
        const long long* maps, const FwdArgs& a, int B, int D, void* stream) {
  if (B <= 0 || a.Tq <= 0 || a.H <= 0) return 0;
  if (a.Tk <= 0 || dtype != kBF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return by_causal<32, CARRY>(causal, ptrs, maps, a, B, s);
    case 64: return by_causal<64, CARRY>(causal, ptrs, maps, a, B, s);
    case 128: return by_causal<128, CARRY>(causal, ptrs, maps, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q [B, Tq, H, D], k/v [B, Tk, H, D], bf16 (dtype code 1; any other is
// refused), described by `maps`: 12 numbers each for q, k, v, as
// `_tma_layout` works them out (dims {D, H, T, B}, byte strides {h, t,
// b}, box {columns, 1, rows, 1}, swizzle bytes). o is a contiguous
// [B, Tq, H, D] bf16, lse a contiguous [B, H, Tq] fp32. D must be 32, 64
// or 128. Returns cudaGetLastError() after the launch, or the error that
// kept it from launching.
extern "C" int dl4j_flash_attention_fwd_sm90(int dtype, int causal,
                                             const void* q, const void* k,
                                             const void* v, void* o,
                                             float* lse, int B, int Tq, int Tk,
                                             int H, int D,
                                             const long long* maps,
                                             float scale, void* stream) {
  dl4j::FwdArgs a{};
  a.o = o;
  a.lse = lse;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.scale = scale;
  const void* const ptrs[3] = {q, k, v};
  return dl4j::run<false>(dtype, causal, ptrs, maps, a, B, D, stream);
}

// The carry fold: q, k, v and `maps` as above; m, l a contiguous
// [B, H, Tq] fp32 and acc a contiguous [B, H, Tq, D] fp32 hold the
// running state and are updated IN PLACE. `diag` masks k_pos > q_pos
// between local positions (the caller guarantees Tq == Tk then).
extern "C" int dl4j_flash_attention_carry_sm90(int dtype, int diag,
                                               const void* q, const void* k,
                                               const void* v, float* m,
                                               float* l, float* acc, int B,
                                               int Tq, int Tk, int H, int D,
                                               const long long* maps,
                                               float scale, void* stream) {
  dl4j::FwdArgs a{};
  a.m = m;
  a.l = l;
  a.acc = acc;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.scale = scale;
  const void* const ptrs[3] = {q, k, v};
  return dl4j::run<true>(dtype, diag, ptrs, maps, a, B, D, stream);
}
