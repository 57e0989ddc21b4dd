// Flash-attention backward for Hopper (sm_90a): two kernels, dK/dV and dQ,
// their products on the tensor cores through wgmma, fed by TMA.
//
// Replaces tensorforth_tpu/ops/attn_pallas.py:_flash_bwd_dkv_kernel (line
// 172) and :_flash_bwd_dq_kernel (226), both launched by
// flash_attention_bwd.  Given q, k, v, the forward's log-sum-exp `lse`
// (nats), the output cotangent `do` and delta = sum_d do*o - dlse, they
// compute per (batch*head), with q2 = q*scale*log2e,
//   s2 = q2 k^T, causal mask,   p = exp2(s2 - lse*log2e)
//   dp = do v^T,                ds = p * (dp - delta)
//   dv = p^T do,   dk = ln2 * ds^T q2,   dq = scale * ds k
// with the S x S tiles p and ds kept in registers.  q2 and delta are formed
// outside (the split below; one row reduction) and log2e is folded into
// lse as it is read, so a probability costs one exp2.
//
// Layout: q2, k, v, do as bf16 parts [NP, B*h, S, dh] (NP 3: hi, mid, lo
// from t4_split_bwd, the f32 class; 1: the hybrid class's casts); lse and
// delta [B*h, S] f32; dq, dk, dv [B*h, S, dh] f32.  S % 64 == 0, dh in
// {128, 256, ..., 1024} (a multiple of 128).
//
// Two classes, one pair of kernels (NP, the parts of each operand):
//   f32 (NP 3): each product is six bf16 products of the three-part split
//     (split_bf16.cuh: x = hi + mid + lo exactly), smallest first: lo hi,
//     mid mid, hi lo, mid hi, hi mid, hi hi.  The scores s2 and dp take all
//     six over dh into one accumulator; a gradient product takes them over
//     a tile's 32 rows into a fresh accumulator that the CUDA cores add to
//     the running sum (the tensor cores' adds truncate: the small terms go
//     in while a sum is small).  p and ds are split in registers.
//   hybrid (NP 1): the wrapper's bf16 casts, one product each, summed in
//     the running accumulator; p and ds round to bf16 (cvt.rn) before their
//     products, ds formed from the unrounded p, as the Pallas kernels' bf16
//     multiplicands are.
// dh 256 in the f32 class, and dh 384 to 1024 in both classes, run on a
// cluster of CL = dh / 128 CTAs that split dh (the cluster kernels below):
// three parts of a stationary and of a streamed tile at dh 256 do not fit
// one CTA's 227 KB, nor one part of them at dh 512 in two stages, nor
// would a warpgroup's 256 columns of dk and dv fit its registers; so each
// CTA of the cluster holds what the dh-128 body of its class holds, over
// its 128 columns.
//
// What bounds them on this card: operations.  At the training slice's
// shape ([64, 2048, 128] causal) dK/dV does 4 products = 137.5 GFLOP and
// dQ 3 = 103.1 GFLOP; six times that in the f32 class, at the 989 TFLOP/s
// of bf16 wgmma: 0.834 and 0.626 ms.  Their bytes (the parts read once,
// the gradients written once) take under 0.1 ms.  The split of q2, k, v
// and do (671 MB read and written) is bound by bytes: 0.200 ms.
//
// The design.  Both kernels have one shape.  A CTA of two warpgroups owns
// 64 stationary rows of one head (dQ: query rows, with Q2 and dO; dK/dV:
// key rows, with K and V), all parts of both in shared memory for the
// CTA; the other side streams through in TILE-row tiles (64 at dh 128, 32
// at dh 256 in the hybrid class), each of its two operands in a ring of ST
// stages (one in the f32 class, whose parts fill 192 KB at dh 128; two in
// the hybrid class).
// Thread 0 issues every TMA load (128-byte swizzle).  Per streamed tile a
// warpgroup takes 32 of its rows:
//   dp = A1 B1^T, s2 = A0 B0^T   m64n32 over dh, the stationary operand
//                (A) and the streamed one (B) K-major from the swizzled
//                tiles.  dQ: dp = dO V^T, s2 = Q2 K^T.  dK/dV: dp^T = V
//                dO^T, s2^T = K Q2^T, the key rows on wgmma's M, so that p
//                and ds leave the accumulators as A operands of the next
//                products
//   p, ds        on the CUDA cores in the accumulators (exp2 by
//                ex2.approx; only a tile that crosses the diagonal tests
//                the mask), then as bf16 A fragments in registers
//   dK/dV: dv += p^T dO, dk += ds^T Q2;   dQ: dq += ds K
//                m64nN over the 32 rows, B MN-major (the transpose bit)
// At dh 128 each warpgroup owns all 128 output columns and half of each
// tile's rows, so no product is formed twice; warpgroup 1's sums reach
// warpgroup 0 through shared memory at the end and are added in one order.
// At dh 256 in the hybrid class each owns 128 of the columns, and both
// take all 32 rows of a tile.  The loads overlap the products: the operand
// of a tile's last product loads during the next tile's first (dQ: K after
// ds K, during dO V^T; dK/dV: Q2 after ds^T Q2, during V dO^T), the other
// one during the softmax and the products after it.
// EVERY OUTPUT ELEMENT HAS ONE WRITER and its sums one order: no atomics,
// and the gradients are the same bits from run to run.  Under the causal
// mask a streamed tile that lies wholly in the future is never visited,
// and the grid hands out the longest CTAs first (dQ the last query tiles,
// dK/dV the first key tiles).
// Registers at dh 128, f32: dK/dV holds dk and dv (64 each), a fresh
// accumulator of 64 columns (32; the products go in two column halves), s2
// and dp (16 each), p's and ds's parts (24 each); dQ holds dq and a fresh
// m64n128 accumulator (64 each) and ds's parts.
//
// The cluster route: CL CTAs per 64 stationary rows (CL 2 at dh 256 in the
// f32 class, 3 to 8 at dh 384 to 1024; the grid has CL CTAs per row block,
// blockIdx.x / CL picks the block and the CTA's rank in the cluster its
// 128 columns of dh).  Each CTA runs the dh-128 body of its class over its
// columns: the maps' boxes start at column 128 rank, so its tiles hold
// exactly what that body's hold (f32: three parts of both stationary
// operands, 96 KB, and one stage of both streamed operands in 64-row
// tiles, 96 KB; hybrid: one part, two stages, 96 KB in all).  Its s2 and
// dp are then partial sums over its columns.  Per tile the CTAs add them
// through distributed shared memory.  A pair (CL 2, dh 256) uses Xch
// (sm90_gemm.cuh): each thread sends its two partials (32 floats: dp's
// while s2's products still run) to its twin in the other CTA and adds
// the twin's.  At CL 3 to 8 (dh 384 to 1024) Xrs takes two balanced
// rounds: a reduce-scatter (a thread's 32 floats are 8 quads, each owned
// by one CTA: quad q by CTA q mod CL at CL 4 and 8, else staggered by warp
// so that every CTA owns about 8 / CL of them; the owner receives every
// peer's partial of its quads and adds the CL partials in cluster_sum's
// order, ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7)), absent ranks
// dropped) and an all-gather of the owners' sums, so p and ds are the same
// bits in every CTA.  Every store is a 16-byte st.async.  The f32 class
// has ONE 32 KB SLOT beside its tiles, so a round's sender waits for the
// reads of the last round that used its targets' slots; the hybrid class
// has two, one a round, and no sender waits.  The gradient products then
// run over the CTA's own columns (dk[:, cols] += ds^T Q2[:, cols],
// dv[:, cols] += p^T dO[:, cols]; dq[:, cols] += ds K[:, cols]): every
// output element keeps one writer.  A
// cluster barrier after the barriers' set-up comes before any remote store
// or arrival; in a pair, the wait for the last reads of its messages after
// the loop keeps a CTA's shared memory alive until its peer is done with
// it (Xrs's readers await every message, and leave the last one
// unsignalled).
// Shared memory in the f32 class: 1,024 alignment + 196,608 tiles + 32,768
// exchange + 512 lse and delta (dK/dV) + 40 barriers (56 at CL 3 to 8:
// Xrs's two receipts and two reads) = 230,952 (230,968) of 232,448 bytes;
// in the hybrid class at CL 3 to 8: 1,024 + 98,304 tiles + 65,536 (two
// slots) + 1,024 lse and delta + 56 barriers = 165,944 bytes.

#include "flash_tile.cuh"
#include "sm90_gemm.cuh"
#include "split_bf16.cuh"

#include <initializer_list>

namespace {

// the operands of a backward launch, shared by the C entry points
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int bh, s, causal;
  cudaStream_t stream;
};

// ===========================================================================
// bf16 wgmma: head dim D, NP parts of each operand, CL CTAs of a cluster
// that split dh (each holds DC = D / CL of its columns)
// ===========================================================================
template <int D, int NP, int CL = 1>
struct Bwd {
  static constexpr int PARTS = NP;
  static constexpr int DC = D / CL;                  // a CTA's columns
  static constexpr int ROWS = 64;                    // stationary rows
  static constexpr int TILE = DC == 128 ? 64 : 32;   // streamed tile rows
  static constexpr int ST = NP == 1 ? 2 : 1;         // stages of each
                                                     // streamed operand
  static constexpr int NB = DC / 64;                 // 128-byte column boxes
  static constexpr int RBOX = ROWS * 128;            // a stationary box
  static constexpr int TBOX = TILE * 128;            // a streamed box
  static constexpr int R_PART = NB * RBOX;
  static constexpr int T_PART = NB * TBOX;
  static constexpr int R_BYTES = NP * R_PART;        // a stationary operand
  static constexpr int T_BYTES = NP * T_PART;        // a streamed stage
  static constexpr int ROWS_WG = DC == 128 ? 32 : 0; // streamed rows' offset
  static constexpr int COLS_WG = DC == 128 ? 0 : 128;// output columns' offset
  // a cluster's exchange: Xch's pair at CL 2, Xrs's two balanced
  // rounds at CL 3 to 8, in SLOTS slots of 32 floats for each thread (two
  // in the hybrid class, which has the room: no sender waits)
  static constexpr int SLOTS = CL <= 2 ? 1 : NP == 1 ? 2 : 1;
  static constexpr int XCH = CL > 1 ? SLOTS * NT * 32 * 4 : 0;
  // barriers: the stationary operands', each stage's of each streamed
  // operand, and a cluster's of the exchange (Xch: full and empty;
  // Xrs: a round's receipt each, and with one slot a round's reads each)
  static constexpr int NBAR =
      1 + 2 * ST +
      (CL == 1   ? 0
       : CL == 2 ? Xch<NT>::NBAR
                 : Xrs<CL < 3 ? 3 : CL, NT, 0, SLOTS>::NBAR);
  // both stationary operands, ST stages of both streamed ones, the exchange
  // slots, (dK/dV) the streamed rows' lse and delta of each stage, then the
  // barriers
  static constexpr int TILES = ALIGN + 2 * R_BYTES + 2 * ST * T_BYTES;
  static constexpr int SMEM_DQ = TILES + XCH + NBAR * 8;
  static constexpr int SMEM_DKV = SMEM_DQ + 2 * ST * TILE * 4;
  static constexpr int P0 = NP == 3 ? 0 : 5;   // first of prod_a/prod_b's
};
static_assert(Bwd<128, 3>::SMEM_DKV <= SMEM_LIMIT &&
                  Bwd<128, 1>::SMEM_DKV <= SMEM_LIMIT &&
                  Bwd<256, 1>::SMEM_DKV <= SMEM_LIMIT &&
                  Bwd<256, 3, 2>::SMEM_DKV <= SMEM_LIMIT,
              "shared memory");
static_assert(Bwd<256, 3, 2>::SMEM_DKV == 230952, "the cluster's budget");
// dh 384 to 1024, both classes, on clusters of 3 to 8 CTAs (Xrs): the f32
// class's budget is the dh-256 route's with two more barriers (the rounds'
// receipts and reads), 230,968 of 232,448 bytes, one slot; the hybrid
// class's CTA holds the dh-128 hybrid tiles, two slots and two barriers
static_assert(Bwd<384, 3, 3>::SMEM_DKV == 230968 &&
                  Bwd<512, 3, 4>::SMEM_DKV == 230968 &&
                  Bwd<640, 3, 5>::SMEM_DKV == 230968 &&
                  Bwd<768, 3, 6>::SMEM_DKV == 230968 &&
                  Bwd<896, 3, 7>::SMEM_DKV == 230968 &&
                  Bwd<1024, 3, 8>::SMEM_DKV == 230968 &&
                  Bwd<1024, 3, 8>::SMEM_DKV <= SMEM_LIMIT &&
                  Bwd<1024, 3, 8>::SMEM_DQ == 230456,
              "the f32 clusters' budget");
static_assert(Bwd<384, 1, 3>::SMEM_DKV == 165944 &&
                  Bwd<512, 1, 4>::SMEM_DKV == 165944 &&
                  Bwd<640, 1, 5>::SMEM_DKV == 165944 &&
                  Bwd<768, 1, 6>::SMEM_DKV == 165944 &&
                  Bwd<896, 1, 7>::SMEM_DKV == 165944 &&
                  Bwd<1024, 1, 8>::SMEM_DKV == 165944 &&
                  Bwd<1024, 1, 8>::SMEM_DQ == 164920,
              "the hybrid clusters' budget");
// Xrs's round-1 pools fit the slot: at most 60 of its 64 warp-planes
static_assert(2 * Xrs<7, NT, 0, 1>::span(0) == 60 &&
                  2 * Xrs<6, NT, 0, 1>::span(1) == 60 &&
                  2 * Xrs<5, NT, 0, 1>::span(2) == 56 &&
                  2 * Xrs<8, NT, 0, 1>::span(0) == 56,
              "an exchange slot");
// dh 128 adds warpgroup 1's dk and dv (64 KB) to warpgroup 0's through the
// tiles' space
static_assert(Bwd<128, 1>::TILES - ALIGN >= 2 * 64 * 128 * 4, "reduction");

// one tile of an operand (the map's box of rows, from `row` on, P::NB
// boxes of 64 columns from column `col` on) in each of its parts, by TMA
// into shared memory at dst (part p at p part_bytes, its 64-column boxes
// box_bytes apart; part p's rows start p part_rows down the map), against
// `bar`, whose bytes the caller expects
template <class P>
__device__ __forceinline__ void tma_parts(uint32_t dst, uint32_t bar,
                                          const CUtensorMap* map,
                                          int part_rows, int row, int col,
                                          int part_bytes, int box_bytes) {
#pragma unroll
  for (int p = 0; p < P::PARTS; ++p)
#pragma unroll
    for (int b = 0; b < P::NB; ++b)
      tma_load(dst + p * part_bytes + b * box_bytes, map, bar, col + 64 * b,
               p * part_rows + row);
}

// a streamed tile from `row` on into the stage at dst, and for dK/dV the
// tile's rows of `rows_src` (lse or delta) to rows_dst; one thread
template <class P, bool DKV>
__device__ __forceinline__ void load_stream(uint32_t dst, uint32_t bar,
                                            const CUtensorMap* map,
                                            int part_rows, int row, int col,
                                            const float* rows_src,
                                            uint32_t rows_dst) {
  mbar_expect_tx(bar, P::T_BYTES + (DKV ? P::TILE * 4 : 0));
  tma_parts<P>(dst, bar, map, part_rows, row, col, P::T_PART, P::TBOX);
  if constexpr (DKV) bulk_load(rows_dst, rows_src + row, P::TILE * 4, bar);
}

// s (+)= A B^T over the CTA's columns, m64n32: A the stationary operand's
// 64 rows at a, B 32 rows of a streamed tile at b, both K-major (parts
// R_PART and T_PART apart); the class's products, smallest first, into one
// accumulator
template <class P>
__device__ __forceinline__ void score_products(float (&s)[16], uint32_t a,
                                               uint32_t b) {
#pragma unroll
  for (int p = P::P0; p < 6; ++p)
#pragma unroll
    for (int kk = 0; kk < P::DC / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;   // 16 of dh in a box
      wgmma_32<0, 0>(
          s, desc_a(a + prod_a(p) * P::R_PART + (kk / 4) * P::RBOX + col),
          desc_a(b + prod_b(p) * P::T_PART + (kk / 4) * P::TBOX + col),
          p > P::P0 || kk > 0);
    }
}

// a [64 x 32] accumulator (m64n32's layout) as the bf16 A fragments of
// the k16 steps over its 32 columns, in NP parts: step kk, register u of a
// part holds elements 8 kk + 2 u and 8 kk + 2 u + 1
template <int NP>
__device__ __forceinline__ void to_frags(const float (&x)[16],
                                         uint32_t (&f)[NP][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t w[NP];
    split_pair<NP>(x[2 * i], x[2 * i + 1], w);
#pragma unroll
    for (int p = 0; p < NP; ++p) f[p][i] = w[p];
  }
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a,
                                       uint64_t b, int scale_d) {
  if constexpr (N == 128)
    wgmma_128_rs(d, a[0], a[1], a[2], a[3], b, scale_d);
  else
    wgmma_64_rs(d, a[0], a[1], a[2], a[3], b, scale_d);
}

// acc (m64n128: 64 rows x the warpgroup's 128 columns) += F B over 32
// streamed rows: F the parts of a [64 x 32] A operand in registers, B
// those rows of a streamed tile at b, MN-major (parts T_PART apart,
// 64-column boxes TBOX apart), from the tile's column dn on.  Hybrid: the
// one product into acc.  f32: the six products into a fresh accumulator of
// FN columns at a time, which the CUDA cores add to acc.
template <class P, int FN>
__device__ __forceinline__ void grad_products(float (&acc)[64],
                                              uint32_t (&f)[P::PARTS][8],
                                              uint32_t b, int dn) {
  if constexpr (P::PARTS == 1) {
    const uint64_t bd = desc_b(b + (dn / 64) * P::TBOX, P::TBOX);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_128_rs(acc, f[0][4 * kk], f[0][4 * kk + 1], f[0][4 * kk + 2],
                   f[0][4 * kk + 3], bd + kk * 128, 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  } else {
#pragma unroll
    for (int h = 0; h < 128 / FN; ++h) {
      const uint64_t bd =
          desc_b(b + (dn / 64 + h * (FN / 64)) * P::TBOX, P::TBOX);
      float fresh[FN / 2];
      pin(fresh);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          mma_rs<FN>(fresh, f[prod_a(p)] + 4 * kk,
                     bd + ((prod_b(p) * P::T_PART) >> 4) + kk * 128,
                     p > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(fresh);
#pragma unroll
      for (int x = 0; x < FN / 2; ++x) acc[h * (FN / 2) + x] += fresh[x];
    }
  }
  // the products that read f are done
#pragma unroll
  for (int p = 0; p < P::PARTS; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(f[p][i])::"memory");
}

// both kernels' body (DKV: dK/dV, else dQ), on the maps of the stationary
// operands a0, a1 (dQ: Q2, dO; dK/dV: K, V) and of the streamed ones b0,
// b1 (dQ: K, V; dK/dV: Q2, dO): s2 = a0 b0^T, dp = a1 b1^T, then
// out0 = scale0 * sum ds b0 and (dK/dV) out1 = sum p b1; over a cluster of
// CL CTAs that split dh
template <int D, int NP, bool DKV, int CL>
__device__ __forceinline__ void bwd_body(
    unsigned char* smem_raw, const CUtensorMap* ma0, const CUtensorMap* ma1,
    const CUtensorMap* mb0, const CUtensorMap* mb1, const float* lse,
    const float* delta, float* out0, float* out1, int S, int BH, int causal,
    float scale0) {
  using P = Bwd<D, NP, CL>;
  constexpr int TILE = P::TILE, ST = P::ST;
  constexpr int FN = DKV ? 64 : 128;     // a fresh accumulator's columns
  const uint32_t base = aligned_base(smem_raw);
  float* const fbase =
      reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t sA0 = base, sA1 = sA0 + P::R_BYTES;
  const uint32_t sB0 = sA1 + P::R_BYTES;           // B0's stages, B1's
  const uint32_t sB1 = sB0 + ST * P::T_BYTES;
  const uint32_t sX = sB1 + ST * P::T_BYTES;       // the exchange slots
  const uint32_t sRows = sX + P::XCH;              // dK/dV: [ST][lse,
                                                   // delta][TILE]
  const uint32_t afull = sRows + (DKV ? 2 * ST * TILE * 4 : 0);
  const uint32_t b0full = afull + 8, b1full = b0full + 8 * ST;
  const uint32_t xfull = b1full + 8 * ST;   // a cluster's exchange's

  // the CTA's rank in its cluster picks its columns, the cluster its rows
  const int rank = CL == 1 ? 0 : static_cast<int>(cluster_ctarank());
  const int col0 = rank * P::DC;
  // a cluster: this thread's place in the exchange slot
  const uint32_t xslot = sX + threadIdx.x * 16;
  const int blk = static_cast<int>(blockIdx.x / CL);
  const int n_t = S / P::ROWS;
  const int cta_t = blk / BH;
  const int bh = blk % BH;
  const int r0 = (DKV ? cta_t : n_t - 1 - cta_t) * P::ROWS;  // stationary
  const int part_rows = BH * S;          // rows of one part in the maps
  const int row0 = bh * S;               // the head's first row
  // the streamed tiles it visits, j0 .. j0 + n_it - 1 (at least one, the
  // same in both CTAs of a cluster): under the causal mask dQ's rows see
  // keys up to its last row, dK/dV's keys are seen by the queries from its
  // first row on
  const int j0 = DKV && causal ? r0 / TILE : 0;
  const int n_it = (!DKV && causal ? (r0 + P::ROWS) / TILE : S / TILE) - j0;

  if (threadIdx.x == 0) {
    mbar_init(afull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(b0full + 8 * s, 1);
      mbar_init(b1full + 8 * s, 1);
    }
    if constexpr (CL == 2) {
      Xch<NT>{xslot, xfull}.init();
    } else if constexpr (CL > 2) {
      T4_XRS(CL, NT, P::SLOTS, xslot, xfull, xr.init())
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(afull, 2 * P::R_BYTES);
    tma_parts<P>(sA0, afull, ma0, part_rows, row0 + r0, col0, P::R_PART,
                 P::RBOX);
    tma_parts<P>(sA1, afull, ma1, part_rows, row0 + r0, col0, P::R_PART,
                 P::RBOX);
    for (int s = 0; s < ST && s < n_it; ++s) {
      const int row = row0 + (j0 + s) * TILE;
      load_stream<P, DKV>(sB0 + s * P::T_BYTES, b0full + 8 * s, mb0,
                          part_rows, row, col0, lse,
                          sRows + 2 * s * TILE * 4);
      load_stream<P, DKV>(sB1 + s * P::T_BYTES, b1full + 8 * s, mb1,
                          part_rows, row, col0, delta,
                          sRows + (2 * s + 1) * TILE * 4);
    }
  }
  __syncthreads();
  // a cluster: the peers' exchange barriers are set up before any arrival
  if constexpr (CL > 1) cluster_sync();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int fr = warp * 16 + g;          // its fragment rows fr and fr + 8
  const int wr = wg * P::ROWS_WG;        // its rows of a streamed tile
  const int dn = wg * P::COLS_WG;        // its output columns

  // dQ: the base-2 lse and the delta of its two stationary rows
  float l2[2] = {0.f, 0.f}, de[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + r0 + fr + 8 * i;
      l2[i] = lse[row] * LOG2E;
      de[i] = delta[row];
    }
  }

  float acc0[64], acc1[DKV ? 64 : 1], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = 0.f;
  if constexpr (DKV) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc1[i] = 0.f;
  }
  mbar_wait(afull, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % ST;
    const uint32_t phase = (it / ST) & 1;
    const int kb = (j0 + it) * TILE + wr;      // its first streamed row
    const uint32_t b0 = sB0 + st * P::T_BYTES + wr * 128;
    const uint32_t b1 = sB1 + st * P::T_BYTES + wr * 128;
    // thread 0 refills this stage with tile it + ST once both warpgroups
    // are done with it
    const bool refill = threadIdx.x == 0 && it + ST < n_it;
    const int next = row0 + (j0 + it + ST) * TILE;

    // ---- dp = A1 B1^T, then s2 = A0 B0^T [64 x 32] over the CTA's columns
    mbar_wait(b1full + 8 * st, phase);
    pin(dp);
    pin(s);
    wgmma_fence();
    score_products<P>(dp, sA1, b1);
    wgmma_commit();
    mbar_wait(b0full + 8 * st, phase);
    score_products<P>(s, sA0, b0);
    wgmma_commit();
    if constexpr (CL > 1) {
      // ---- a cluster: dp's partial leaves while s2's products run
      wgmma_wait<1>();
      pin(dp);
      if constexpr (CL == 2) {
        xch_send_dp(Xch<NT>{xslot, xfull}, dp, it);
      } else {
        T4_XRS(CL, NT, P::SLOTS, xslot, xfull, xr.send_dp(dp, it))
      }
    }
    wgmma_wait<0>();
    pin(dp);
    pin(s);
    if constexpr (!DKV) {
      named_barrier(1, NT);                    // V's stage is read
      if (refill)
        load_stream<P, DKV>(sB1 + st * P::T_BYTES, b1full + 8 * st, mb1,
                            part_rows, next, col0, nullptr, 0);
    }
    // ---- a cluster: s2's partial leaves too, and both are summed
    if constexpr (CL == 2) {
      xch_sum_scores(Xch<NT>{xslot, xfull}, s, dp, it);
    } else if constexpr (CL > 2) {
      T4_XRS(CL, NT, P::SLOTS, xslot, xfull, xr.sum(s, dp, it))
    }

    // ---- p and ds in place: element 4 jn + 2 i + c is stationary row
    //      r0 + fr + 8 i, streamed row kb + 8 jn + 2 t + c
    const bool diag = causal && (DKV ? r0 + P::ROWS - 1 > kb : kb + 31 > r0);
    const float* Ls = fbase + (sRows - base) / 4 + 2 * st * TILE + wr;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jn + 2 * t + c;
        float lc = 0.f, ec = 0.f;
        if constexpr (DKV) {
          lc = Ls[col] * LOG2E;
          ec = Ls[TILE + col];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * jn + 2 * i + c;
          const int sr = r0 + fr + 8 * i, tr = kb + col;
          float p = ex2(s[x] - (DKV ? lc : l2[i]));
          if (diag && (DKV ? sr > tr : tr > sr)) p = 0.f;
          dp[x] = p * (dp[x] - (DKV ? ec : de[i]));
          s[x] = p;
        }
      }
    // ---- a cluster of 3 to 8: the sums' places are read
    if constexpr (CL > 2) {
      T4_XRS(CL, NT, P::SLOTS, xslot, xfull, xr.read(it, n_it))
    }

    if constexpr (DKV) {
      // ---- dv += p^T dO over its 32 queries
      uint32_t pf[NP][8];
      to_frags<NP>(s, pf);
      grad_products<P, FN>(acc1, pf, b1, dn);
      named_barrier(1, NT);                    // dO's stage is read
      if (refill)
        load_stream<P, DKV>(sB1 + st * P::T_BYTES, b1full + 8 * st, mb1,
                            part_rows, next, col0, delta,
                            sRows + (2 * st + 1) * TILE * 4);
    }
    // ---- dq += ds K  (dQ),  dk += ds^T Q2  (dK/dV)
    uint32_t df[NP][8];
    to_frags<NP>(dp, df);
    grad_products<P, FN>(acc0, df, b0, dn);
    named_barrier(1, NT);                      // K's (Q2's) stage is read
    if (refill)
      load_stream<P, DKV>(sB0 + st * P::T_BYTES, b0full + 8 * st, mb0,
                          part_rows, next, col0, lse,
                          sRows + 2 * st * TILE * 4);
  }
  // ---- a pair (CL 2): its peer has read its messages for the last time,
  //      so no access to this CTA's shared memory is left (Xrs leaves none
  //      after its loop)
  if constexpr (CL == 2) {
    Xch<NT>{xslot, xfull}.drain(n_it);
  }

  // ---- 128 columns a CTA: warpgroup 1's sums to warpgroup 0 through the
  //      tiles' space, which no product reads after the loop's last barrier
  if constexpr (P::COLS_WG == 0) {
    const int tid = threadIdx.x % 128;
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) fbase[i * 128 + tid] = acc0[i];
      if constexpr (DKV) {
#pragma unroll
        for (int i = 0; i < 64; ++i) fbase[(64 + i) * 128 + tid] = acc1[i];
      }
    }
    named_barrier(1, NT);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] += fbase[i * 128 + tid];
    if constexpr (DKV) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc1[i] += fbase[(64 + i) * 128 + tid];
    }
  }

  // ---- store its rows: element 4 jn + 2 i + c is column col0 + dn + 8 jn
  //      + 2 t + c of stationary row r0 + fr + 8 i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = (static_cast<size_t>(row0) + r0 + fr + 8 * i) * D +
                      col0 + dn + 2 * t;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      *reinterpret_cast<float2*>(out0 + at + 8 * jn) =
          make_float2(acc0[4 * jn + 2 * i] * scale0,
                      acc0[4 * jn + 2 * i + 1] * scale0);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(out1 + at + 8 * jn) =
            make_float2(acc1[4 * jn + 2 * i], acc1[4 * jn + 2 * i + 1]);
    }
  }
}

// two warpgroups and no producer warp, so that a thread may hold 255
// registers; thread 0 issues the TMA loads.  CL > 1: launched in clusters
// of CL CTAs that split dh.
template <int D, int NP, int CL>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int S, int BH, int causal) {
  extern __shared__ unsigned char smem_raw[];
  bwd_body<D, NP, true, CL>(smem_raw, &mk, &mv, &mq, &mo, lse, delta, dk,
                            dv, S, BH, causal, LN2);
}

template <int D, int NP, int CL>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mo,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int S, int BH,
                             int causal, float oscale) {
  extern __shared__ unsigned char smem_raw[];
  bwd_body<D, NP, false, CL>(smem_raw, &mq, &mo, &mk, &mv, lse, delta, dq,
                             nullptr, S, BH, causal, oscale);
}

// (rows, tile, stages, smem, cluster) name the plan (ops/attn.py:bwd_plan);
// one the library was not built with is refused
template <int D, int NP, int CL>
int launch_sm90(const BwdArgs& a, bool dkv, float* out0, float* out1,
                float oscale, int rows, int tile, int stages, int smem,
                int cluster) {
  using P = Bwd<D, NP, CL>;
  if (rows != P::ROWS || tile != P::TILE || stages != P::ST ||
      cluster != CL || smem != (dkv ? P::SMEM_DKV : P::SMEM_DQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int n = NP * a.bh * a.s;         // every part's rows, one map
  // the stationary operands (box of ROWS rows), then the streamed ones
  const void* ops[4] = {dkv ? a.k : a.q, dkv ? a.v : a.dout,
                        dkv ? a.q : a.k, dkv ? a.dout : a.v};
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i)
    if (!make_map(&m[i], fn, ops[i], n, D, D, 64, i < 2 ? P::ROWS : P::TILE))
      return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(CL * a.bh) * (a.s / P::ROWS));
  if (dkv)
    return launch_cluster(flash_bwd_dkv_sm90_kernel<D, NP, CL>, grid, CL, NT,
                          smem, a.stream, m[0], m[1], m[2], m[3], a.lse,
                          a.delta, out0, out1, a.s, a.bh, a.causal);
  return launch_cluster(flash_bwd_dq_sm90_kernel<D, NP, CL>, grid, CL, NT,
                        smem, a.stream, m[0], m[1], m[2], m[3], a.lse,
                        a.delta, out0, a.s, a.bh, a.causal, oscale);
}

// shapes the kernels take, operands 16-byte and outputs 8-byte aligned
bool bad_args(int bh, int s, int dh, std::initializer_list<const void*> in,
              std::initializer_list<const void*> out) {
  if (bh <= 0 || s <= 0 || s % 64 != 0 || dh % 128 != 0 || dh > 1024)
    return true;
  for (const void* p : in)
    if (!aligned(p, 16)) return true;
  for (const void* p : out)
    if (!aligned(p, 8)) return true;
  return false;
}

}  // namespace

// q2, k, v, dout: the f32 class's parts [3, bh, s, dh] bf16 (t4_split_bwd;
// parts 3; at dh 256 on a cluster of two CTAs), the hybrid class's casts
// [bh, s, dh] bf16 (parts 1); both classes at dh 384 to 1024 on clusters
// of dh / 128 CTAs (dh 1152 and wider are refused); q already times
// scale*log2e, 16-byte aligned; lse and delta [bh, s] f32, 16-byte
// aligned; dk and dv [bh, s, dh] f32.  (rows, tile, stages, smem, cluster)
// name the plan
// (ops/attn.py:bwd_plan); another is refused.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int t4_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int s, int dh, int causal, int parts,
                                int rows, int tile, int stages, int smem,
                                int cluster, void* stream) {
  if (bad_args(bh, s, dh, {q, k, v, dout, lse, delta}, {dk, dv}))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), bh, s, causal,
                  static_cast<cudaStream_t>(stream)};
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
#define T4_DKV(D, NP, CL)                                              \
  launch_sm90<D, NP, CL>(a, true, dkf, dvf, 0.f, rows, tile, stages, smem, \
                         cluster)
  if (dh == 128 && parts == 3) return T4_DKV(128, 3, 1);
  if (dh == 128 && parts == 1) return T4_DKV(128, 1, 1);
  if (dh == 256 && parts == 3) return T4_DKV(256, 3, 2);
  if (dh == 256 && parts == 1) return T4_DKV(256, 1, 1);
  if (dh == 384 && parts == 3) return T4_DKV(384, 3, 3);
  if (dh == 384 && parts == 1) return T4_DKV(384, 1, 3);
  if (dh == 512 && parts == 3) return T4_DKV(512, 3, 4);
  if (dh == 512 && parts == 1) return T4_DKV(512, 1, 4);
  if (dh == 640 && parts == 3) return T4_DKV(640, 3, 5);
  if (dh == 640 && parts == 1) return T4_DKV(640, 1, 5);
  if (dh == 768 && parts == 3) return T4_DKV(768, 3, 6);
  if (dh == 768 && parts == 1) return T4_DKV(768, 1, 6);
  if (dh == 896 && parts == 3) return T4_DKV(896, 3, 7);
  if (dh == 896 && parts == 1) return T4_DKV(896, 1, 7);
  if (dh == 1024 && parts == 3) return T4_DKV(1024, 3, 8);
  if (dh == 1024 && parts == 1) return T4_DKV(1024, 1, 8);
#undef T4_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

// as above, dq [bh, s, dh] f32 = oscale * ds k
extern "C" int t4_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int s,
                               int dh, int causal, int parts, int rows,
                               int tile, int stages, int smem, int cluster,
                               float oscale, void* stream) {
  if (bad_args(bh, s, dh, {q, k, v, dout, lse, delta}, {dq}))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), bh, s, causal,
                  static_cast<cudaStream_t>(stream)};
  float* dqf = static_cast<float*>(dq);
#define T4_DQ(D, NP, CL)                                                  \
  launch_sm90<D, NP, CL>(a, false, dqf, nullptr, oscale, rows, tile, stages, \
                         smem, cluster)
  if (dh == 128 && parts == 3) return T4_DQ(128, 3, 1);
  if (dh == 128 && parts == 1) return T4_DQ(128, 1, 1);
  if (dh == 256 && parts == 3) return T4_DQ(256, 3, 2);
  if (dh == 256 && parts == 1) return T4_DQ(256, 1, 1);
  if (dh == 384 && parts == 3) return T4_DQ(384, 3, 3);
  if (dh == 384 && parts == 1) return T4_DQ(384, 1, 3);
  if (dh == 512 && parts == 3) return T4_DQ(512, 3, 4);
  if (dh == 512 && parts == 1) return T4_DQ(512, 1, 4);
  if (dh == 640 && parts == 3) return T4_DQ(640, 3, 5);
  if (dh == 640 && parts == 1) return T4_DQ(640, 1, 5);
  if (dh == 768 && parts == 3) return T4_DQ(768, 3, 6);
  if (dh == 768 && parts == 1) return T4_DQ(768, 1, 6);
  if (dh == 896 && parts == 3) return T4_DQ(896, 3, 7);
  if (dh == 896 && parts == 1) return T4_DQ(896, 1, 7);
  if (dh == 1024 && parts == 3) return T4_DQ(1024, 3, 8);
  if (dh == 1024 && parts == 1) return T4_DQ(1024, 1, 8);
#undef T4_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

// the most clusters of a backward kernel's route at (dh, parts) that the
// card runs at once, into *n (dkv != 0: dK/dV, else dQ; one CTA a cluster
// off the cluster routes); 0 or the query's cudaError_t
extern "C" int t4_flash_bwd_clusters(int dh, int parts, int dkv, void* n) {
  int* out = static_cast<int*>(n);
#define T4_BWD_CL(D, NP, CL)                                                 \
  (dkv ? max_clusters(flash_bwd_dkv_sm90_kernel<D, NP, CL>, CL, NT,          \
                      Bwd<D, NP, CL>::SMEM_DKV, out)                         \
       : max_clusters(flash_bwd_dq_sm90_kernel<D, NP, CL>, CL, NT,           \
                      Bwd<D, NP, CL>::SMEM_DQ, out))
  if (dh == 128 && parts == 3) return T4_BWD_CL(128, 3, 1);
  if (dh == 128 && parts == 1) return T4_BWD_CL(128, 1, 1);
  if (dh == 256 && parts == 3) return T4_BWD_CL(256, 3, 2);
  if (dh == 256 && parts == 1) return T4_BWD_CL(256, 1, 1);
  if (dh == 384 && parts == 3) return T4_BWD_CL(384, 3, 3);
  if (dh == 384 && parts == 1) return T4_BWD_CL(384, 1, 3);
  if (dh == 512 && parts == 3) return T4_BWD_CL(512, 3, 4);
  if (dh == 512 && parts == 1) return T4_BWD_CL(512, 1, 4);
  if (dh == 640 && parts == 3) return T4_BWD_CL(640, 3, 5);
  if (dh == 640 && parts == 1) return T4_BWD_CL(640, 1, 5);
  if (dh == 768 && parts == 3) return T4_BWD_CL(768, 3, 6);
  if (dh == 768 && parts == 1) return T4_BWD_CL(768, 1, 6);
  if (dh == 896 && parts == 3) return T4_BWD_CL(896, 3, 7);
  if (dh == 896 && parts == 1) return T4_BWD_CL(896, 1, 7);
  if (dh == 1024 && parts == 3) return T4_BWD_CL(1024, 3, 8);
  if (dh == 1024 && parts == 1) return T4_BWD_CL(1024, 1, 8);
#undef T4_BWD_CL
  return static_cast<int>(cudaErrorInvalidValue);
}

// the f32 class's operands: q * qscale, k, v and dout [rows, cols] f32
// (cols % 8 == 0, contiguous) -> out [4 (q, k, v, dout), 3 (hi, mid, lo),
// rows, cols] bf16, 16-byte aligned, x = hi + mid + lo (split_bf16.cuh);
// one launch
extern "C" int t4_split_bwd(const float* q, const float* k, const float* v,
                            const float* dout, void* out, int rows, int cols,
                            float qscale, void* stream) {
  if (rows < 1 || cols < 8 || cols % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* parts = static_cast<__nv_bfloat16*>(out);
  const size_t op = 3 * static_cast<size_t>(rows) * cols;   // an operand's
  const float* in[4] = {q, k, v, dout};
  SplitJob jobs[4];
  for (int i = 0; i < 4; ++i)
    jobs[i] = {in[i], parts + i * op, rows, cols, cols,
               aligned(in[i], 16) ? 1 : 0, i == 0 ? qscale : 1.f};
  return launch_split(3, jobs, 4, static_cast<cudaStream_t>(stream));
}
