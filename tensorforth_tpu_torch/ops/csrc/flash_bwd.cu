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
// {128, 256}.
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
// dh 256 in the f32 class keeps the strict-f32 FMA kernels at the end of
// this file (flash_bwd_tile.cuh's phases; ops/attn.py:bwd_plan picks them
// by dh): three parts of a stationary and of a streamed 64-row tile at dh
// 256 take 384 KB, and even 16 streamed rows 240 KB, against a block's
// 227 KB.
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
// at dh 256), each of its two operands in a ring of ST stages (one in the
// f32 class, whose parts fill 192 KB at dh 128; two in the hybrid class).
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
// At dh 256 each owns 128 of the columns, and both take all 32 rows of a
// tile.  The loads overlap the products: the operand of a tile's last
// product loads during the next tile's first (dQ: K after ds K, during dO
// V^T; dK/dV: Q2 after ds^T Q2, during V dO^T), the other one during the
// softmax and the products after it.
// EVERY OUTPUT ELEMENT HAS ONE WRITER and its sums one order: no atomics,
// and the gradients are the same bits from run to run.  Under the causal
// mask a streamed tile that lies wholly in the future is never visited,
// and the grid hands out the longest CTAs first (dQ the last query tiles,
// dK/dV the first key tiles).
// Registers at dh 128, f32: dK/dV holds dk and dv (64 each), a fresh
// accumulator of 64 columns (32; the products go in two column halves), s2
// and dp (16 each), p's and ds's parts (24 each); dQ holds dq and a fresh
// m64n128 accumulator (64 each) and ds's parts.

#include "flash_bwd_tile.cuh"
#include "sm90_gemm.cuh"
#include "split_bf16.cuh"

#include <initializer_list>

namespace {

// ===========================================================================
// bf16 wgmma: dh 128 in both classes, dh 256 in the hybrid class
// ===========================================================================
template <int D, int NP>
struct Bwd {
  static constexpr int ROWS = 64;                    // stationary rows
  static constexpr int TILE = D == 128 ? 64 : 32;    // streamed tile rows
  static constexpr int ST = NP == 1 ? 2 : 1;         // stages of each
                                                     // streamed operand
  static constexpr int NB = D / 64;                  // 128-byte column boxes
  static constexpr int RBOX = ROWS * 128;            // a stationary box
  static constexpr int TBOX = TILE * 128;            // a streamed box
  static constexpr int R_PART = NB * RBOX;
  static constexpr int T_PART = NB * TBOX;
  static constexpr int R_BYTES = NP * R_PART;        // a stationary operand
  static constexpr int T_BYTES = NP * T_PART;        // a streamed stage
  static constexpr int ROWS_WG = D == 128 ? 32 : 0;  // streamed rows' offset
  static constexpr int COLS_WG = D == 128 ? 0 : 128; // output columns' offset
  // both stationary operands, ST stages of both streamed ones, (dK/dV) the
  // streamed rows' lse and delta of each stage, then the barriers: the
  // stationary operands', and each stage's of each streamed operand
  static constexpr int TILES = ALIGN + 2 * R_BYTES + 2 * ST * T_BYTES;
  static constexpr int SMEM_DQ = TILES + (1 + 2 * ST) * 8;
  static constexpr int SMEM_DKV = SMEM_DQ + 2 * ST * TILE * 4;
  static constexpr int P0 = NP == 3 ? 0 : 5;   // first of prod_a/prod_b's
};
static_assert(Bwd<128, 3>::SMEM_DKV <= SMEM_LIMIT &&
                  Bwd<128, 1>::SMEM_DKV <= SMEM_LIMIT &&
                  Bwd<256, 1>::SMEM_DKV <= SMEM_LIMIT,
              "shared memory");
// dh 128 adds warpgroup 1's dk and dv (64 KB) to warpgroup 0's through the
// tiles' space
static_assert(Bwd<128, 1>::TILES - ALIGN >= 2 * 64 * 128 * 4, "reduction");

// one tile of an operand (the map's box of rows, from `row` on) in each of
// its NP parts, by TMA into shared memory at dst (part p at p part_bytes,
// its 64-column boxes box_bytes apart; part p's rows start p part_rows
// down the map), against `bar`, whose bytes the caller expects
template <int D, int NP>
__device__ __forceinline__ void tma_parts(uint32_t dst, uint32_t bar,
                                          const CUtensorMap* map,
                                          int part_rows, int row,
                                          int part_bytes, int box_bytes) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      tma_load(dst + p * part_bytes + b * box_bytes, map, bar, 64 * b,
               p * part_rows + row);
}

// a streamed tile from `row` on into the stage at dst, and for dK/dV the
// tile's rows of `rows_src` (lse or delta) to rows_dst; one thread
template <int D, int NP, bool DKV>
__device__ __forceinline__ void load_stream(uint32_t dst, uint32_t bar,
                                            const CUtensorMap* map,
                                            int part_rows, int row,
                                            const float* rows_src,
                                            uint32_t rows_dst) {
  using P = Bwd<D, NP>;
  mbar_expect_tx(bar, P::T_BYTES + (DKV ? P::TILE * 4 : 0));
  tma_parts<D, NP>(dst, bar, map, part_rows, row, P::T_PART, P::TBOX);
  if constexpr (DKV) bulk_load(rows_dst, rows_src + row, P::TILE * 4, bar);
}

// s (+)= A B^T over dh, m64n32: A the stationary operand's 64 rows at a, B
// 32 rows of a streamed tile at b, both K-major (parts R_PART and T_PART
// apart); the class's products, smallest first, into one accumulator
template <int D, int NP>
__device__ __forceinline__ void score_products(float (&s)[16], uint32_t a,
                                               uint32_t b) {
  using P = Bwd<D, NP>;
#pragma unroll
  for (int p = P::P0; p < 6; ++p)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
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
// streamed rows: F the NP parts of a [64 x 32] A operand in registers, B
// those rows of a streamed tile at b, MN-major (parts T_PART apart,
// 64-column boxes TBOX apart), from column dn on.  Hybrid: the one product
// into acc.  f32: the six products into a fresh accumulator of FN columns
// at a time, which the CUDA cores add to acc.
template <int D, int NP, int FN>
__device__ __forceinline__ void grad_products(float (&acc)[64],
                                              uint32_t (&f)[NP][8],
                                              uint32_t b, int dn) {
  using P = Bwd<D, NP>;
  if constexpr (NP == 1) {
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
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(f[p][i])::"memory");
}

// both kernels' body (DKV: dK/dV, else dQ), on the maps of the stationary
// operands a0, a1 (dQ: Q2, dO; dK/dV: K, V) and of the streamed ones b0,
// b1 (dQ: K, V; dK/dV: Q2, dO): s2 = a0 b0^T, dp = a1 b1^T, then
// out0 = scale0 * sum ds b0 and (dK/dV) out1 = sum p b1
template <int D, int NP, bool DKV>
__device__ __forceinline__ void bwd_body(
    unsigned char* smem_raw, const CUtensorMap* ma0, const CUtensorMap* ma1,
    const CUtensorMap* mb0, const CUtensorMap* mb1, const float* lse,
    const float* delta, float* out0, float* out1, int S, int BH, int causal,
    float scale0) {
  using P = Bwd<D, NP>;
  constexpr int TILE = P::TILE, ST = P::ST;
  constexpr int FN = DKV ? 64 : 128;     // a fresh accumulator's columns
  const uint32_t base = aligned_base(smem_raw);
  float* const fbase =
      reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t sA0 = base, sA1 = sA0 + P::R_BYTES;
  const uint32_t sB0 = sA1 + P::R_BYTES;           // B0's stages, B1's
  const uint32_t sB1 = sB0 + ST * P::T_BYTES;
  const uint32_t sRows = sB1 + ST * P::T_BYTES;    // dK/dV: [ST][lse,
                                                   // delta][TILE]
  const uint32_t afull = sRows + (DKV ? 2 * ST * TILE * 4 : 0);
  const uint32_t b0full = afull + 8, b1full = b0full + 8 * ST;

  const int n_t = S / P::ROWS;
  const int cta_t = static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int r0 = (DKV ? cta_t : n_t - 1 - cta_t) * P::ROWS;  // stationary
  const int part_rows = BH * S;          // rows of one part in the maps
  const int row0 = bh * S;               // the head's first row
  // the streamed tiles it visits, j0 .. j0 + n_it - 1: under the causal
  // mask dQ's rows see keys up to its last row, dK/dV's keys are seen by
  // the queries from its first row on
  const int j0 = DKV && causal ? r0 / TILE : 0;
  const int n_it = (!DKV && causal ? (r0 + P::ROWS) / TILE : S / TILE) - j0;

  if (threadIdx.x == 0) {
    mbar_init(afull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(b0full + 8 * s, 1);
      mbar_init(b1full + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(afull, 2 * P::R_BYTES);
    tma_parts<D, NP>(sA0, afull, ma0, part_rows, row0 + r0, P::R_PART,
                     P::RBOX);
    tma_parts<D, NP>(sA1, afull, ma1, part_rows, row0 + r0, P::R_PART,
                     P::RBOX);
    for (int s = 0; s < ST && s < n_it; ++s) {
      const int row = row0 + (j0 + s) * TILE;
      load_stream<D, NP, DKV>(sB0 + s * P::T_BYTES, b0full + 8 * s, mb0,
                              part_rows, row, lse, sRows + 2 * s * TILE * 4);
      load_stream<D, NP, DKV>(sB1 + s * P::T_BYTES, b1full + 8 * s, mb1,
                              part_rows, row, delta,
                              sRows + (2 * s + 1) * TILE * 4);
    }
  }
  __syncthreads();

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

    // ---- dp = A1 B1^T, then s2 = A0 B0^T [64 x 32] over dh
    mbar_wait(b1full + 8 * st, phase);
    pin(dp);
    pin(s);
    wgmma_fence();
    score_products<D, NP>(dp, sA1, b1);
    wgmma_commit();
    mbar_wait(b0full + 8 * st, phase);
    score_products<D, NP>(s, sA0, b0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dp);
    pin(s);
    if constexpr (!DKV) {
      named_barrier(1, NT);                    // V's stage is read
      if (refill)
        load_stream<D, NP, DKV>(sB1 + st * P::T_BYTES, b1full + 8 * st, mb1,
                                part_rows, next, nullptr, 0);
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

    if constexpr (DKV) {
      // ---- dv += p^T dO over its 32 queries
      uint32_t pf[NP][8];
      to_frags<NP>(s, pf);
      grad_products<D, NP, FN>(acc1, pf, b1, dn);
      named_barrier(1, NT);                    // dO's stage is read
      if (refill)
        load_stream<D, NP, DKV>(sB1 + st * P::T_BYTES, b1full + 8 * st, mb1,
                                part_rows, next, delta,
                                sRows + (2 * st + 1) * TILE * 4);
    }
    // ---- dq += ds K  (dQ),  dk += ds^T Q2  (dK/dV)
    uint32_t df[NP][8];
    to_frags<NP>(dp, df);
    grad_products<D, NP, FN>(acc0, df, b0, dn);
    named_barrier(1, NT);                      // K's (Q2's) stage is read
    if (refill)
      load_stream<D, NP, DKV>(sB0 + st * P::T_BYTES, b0full + 8 * st, mb0,
                              part_rows, next, lse,
                              sRows + 2 * st * TILE * 4);
  }

  // ---- dh 128: warpgroup 1's sums to warpgroup 0 through the tiles'
  //      space, which no product reads after the loop's last barrier
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

  // ---- store its rows: element 4 jn + 2 i + c is column dn + 8 jn + 2 t
  //      + c of stationary row r0 + fr + 8 i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at =
        (static_cast<size_t>(row0) + r0 + fr + 8 * i) * D + dn + 2 * t;
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
// registers; thread 0 issues the TMA loads
template <int D, int NP>
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
  bwd_body<D, NP, true>(smem_raw, &mk, &mv, &mq, &mo, lse, delta, dk, dv, S,
                        BH, causal, LN2);
}

template <int D, int NP>
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
  bwd_body<D, NP, false>(smem_raw, &mq, &mo, &mk, &mv, lse, delta, dq,
                         nullptr, S, BH, causal, oscale);
}

// (rows, tile, stages, smem) name the plan (ops/attn.py:bwd_plan); one the
// library was not built with is refused
template <int D, int NP>
int launch_sm90(const BwdArgs& a, bool dkv, float* out0, float* out1,
                float oscale, int rows, int tile, int stages, int smem) {
  using P = Bwd<D, NP>;
  if (rows != P::ROWS || tile != P::TILE || stages != P::ST ||
      smem != (dkv ? P::SMEM_DKV : P::SMEM_DQ))
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
  const dim3 grid(static_cast<unsigned>(a.bh) * (a.s / P::ROWS));
  if (dkv)
    return launch(flash_bwd_dkv_sm90_kernel<D, NP>, grid, NT, smem, a.stream,
                  m[0], m[1], m[2], m[3], a.lse, a.delta, out0, out1, a.s,
                  a.bh, a.causal);
  return launch(flash_bwd_dq_sm90_kernel<D, NP>, grid, NT, smem, a.stream,
                m[0], m[1], m[2], m[3], a.lse, a.delta, out0, a.s, a.bh,
                a.causal, oscale);
}

// ===========================================================================
// strict-f32 FMAs on the CUDA cores: dh 256 in the f32 class
// ===========================================================================
// 256-thread blocks and 64-row query tiles; a thread holds a 4 x (BK/16)
// block of the score tile and a (rows) x dh/16 block of each output
// accumulator, and reads every multiplicand as float4 from shared-memory
// tiles whose rows are padded by 4 floats.  BK = 32 key rows (219 KB),
// which also halves the dK/dV accumulators to 64 registers each.  The
// sequential grid dimension of the TPU kernels is a loop inside the block.

// dK and dV of one KV tile: K and V stay in shared memory, Q and dO tiles
// stream through it
template <int D, int BK>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int BH, int causal,
                     float qscale) {
  constexpr int LD = D + 4;    // padded row stride of the operand tiles
  constexpr int LDP = BK + 4;  // padded row stride of the p and ds tiles
  constexpr int CJ = BK / 16;  // score columns, and kv rows, per thread
  constexpr int DJ = D / 64;   // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* Os = Qs + BQ * LD;    // the dO tile
  float* Ps = Os + BQ * LD;
  float* Ds = Ps + BQ * LDP;   // the ds tile
  float* Ls = Ds + BQ * LDP;   // base-2 lse of the Q tile's rows
  float* Es = Ls + BQ;         // delta of the Q tile's rows

  const int kt = (int)(blockIdx.x / BH);  // tile 0 sees every query: first
  const int bh = (int)(blockIdx.x % BH);
  const int k0 = kt * BK;
  const size_t head = (size_t)bh * S * D;
  const size_t rows = (size_t)bh * S;
  const int r = threadIdx.x >> 4;  // phase 1: query rows 4r..4r+3;
                                   // phase 2: kv rows CJ*r..CJ*r+CJ-1
  const int c = threadIdx.x & 15;  // phase 1: key columns c+16j;
                                   // phase 2: output columns 64jj+4c..+3

  load_tile<D>(Ks, LD, k + head + (size_t)k0 * D, BK, 1.f);
  load_tile<D>(Vs, LD, v + head + (size_t)k0 * D, BK, 1.f);

  float dka[CJ][DJ][4], dva[CJ][DJ][4];
#pragma unroll
  for (int i = 0; i < CJ; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) dka[i][jj][u] = dva[i][jj][u] = 0.f;

  const int n_q = S / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
    load_q_side<D>(Qs, Os, Ls, Es, q + head, dout + head, lse + rows,
                   delta + rows, q0, qscale);
    __syncthreads();
    pds_tiles<D, BK, true>(Qs, Os, Ks, Vs, Ls, Es, Ps, Ds, q0, k0,
                           causal && k0 + BK - 1 > q0, r, c);
    __syncthreads();
    accum_dkv<D, BK>(dka, dva, Ps, Ds, Os, Qs, r, c);
  }
  store_dkv<D, BK>(dka, dva, dk + head, dv + head, k0, r, c);
}

// dQ of one Q tile: Q and dO stay in shared memory, K and V tiles stream
// through it
template <int D, int BK>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int BH, int causal, float qscale, float oscale) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 4;
  constexpr int DJ = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + BQ * LD;
  float* Ks = Os + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ds = Vs + BK * LD;
  float* Ls = Ds + BQ * LDP;
  float* Es = Ls + BQ;

  const int n_q = S / BQ;
  const int qt = n_q - 1 - (int)(blockIdx.x / BH);  // the last tile sees
                                                    // every key: first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qt * BQ;
  const size_t head = (size_t)bh * S * D;
  const size_t rows = (size_t)bh * S;
  const int r = threadIdx.x >> 4;  // query rows 4r..4r+3, both phases
  const int c = threadIdx.x & 15;  // phase 1: key columns c+16j;
                                   // phase 2: output columns 64jj+4c..+3

  load_q_side<D>(Qs, Os, Ls, Es, q + head, dout + head, lse + rows,
                 delta + rows, q0, qscale);

  float acc[4][DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.f;

  const int kv_tiles = causal ? (q0 + BQ) / BK : S / BK;
  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and ds are consumed
    load_tile<D>(Ks, LD, k + head + (size_t)k0 * D, BK, 1.f);
    load_tile<D>(Vs, LD, v + head + (size_t)k0 * D, BK, 1.f);
    __syncthreads();
    pds_tiles<D, BK, false>(Qs, Os, Ks, Vs, Ls, Es, nullptr, Ds, q0, k0,
                            causal && k0 + BK - 1 > q0, r, c);
    __syncthreads();
    accum_rows<D, BK>(acc, Ds, LDP, Ks, LD, r, c);  // acc += ds K
  }

  // flush: dq = scale * ds k
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dq + head + (size_t)(q0 + 4 * r + i) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      *reinterpret_cast<float4*>(row + 64 * jj + 4 * c) =
          make_float4(acc[i][jj][0] * oscale, acc[i][jj][1] * oscale,
                      acc[i][jj][2] * oscale, acc[i][jj][3] * oscale);
  }
}

constexpr int FMA_D = 256, FMA_BK = 32;  // the FMA route's dh, key rows

// the FMA route's plan: (stationary rows, streamed rows, 1 stage, smem)
bool fma_plan(bool dkv, int rows, int tile, int stages, int smem) {
  return rows == (dkv ? FMA_BK : BQ) && tile == (dkv ? BQ : FMA_BK) &&
         stages == 1 &&
         smem == bwd_smem_floats(FMA_D, FMA_BK, dkv) *
                     static_cast<int>(sizeof(float));
}

cudaError_t launch_dkv_fma(const BwdArgs& a, float* dk, float* dv) {
  constexpr int smem = bwd_smem_floats(FMA_D, FMA_BK, true) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<FMA_D, FMA_BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)a.bh * (unsigned)(a.s / FMA_BK));
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, dk, dv, a.s, a.bh, a.causal, a.qscale);
  return cudaGetLastError();
}

cudaError_t launch_dq_fma(const BwdArgs& a, float* dq, float oscale) {
  constexpr int smem = bwd_smem_floats(FMA_D, FMA_BK, false) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<FMA_D, FMA_BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)a.bh * (unsigned)(a.s / BQ));
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, dq, a.s, a.bh, a.causal, a.qscale, oscale);
  return cudaGetLastError();
}

// shapes the kernels take, operands 16-byte and outputs 8-byte aligned
bool bad_args(int bh, int s, int dh, std::initializer_list<const void*> in,
              std::initializer_list<const void*> out) {
  if (bh <= 0 || s <= 0 || s % 64 != 0 || (dh != 128 && dh != 256))
    return true;
  for (const void* p : in)
    if (!aligned(p, 16)) return true;
  for (const void* p : out)
    if (!aligned(p, 8)) return true;
  return false;
}

}  // namespace

// q2, k, v, dout: the f32 class's parts [3, bh, s, dh] bf16 (t4_split_bwd;
// parts 3), the hybrid class's casts [bh, s, dh] bf16 (parts 1; q already
// times scale*log2e), or at dh 256 in the f32 class f32 [bh, s, dh] (parts
// 0: the FMA route, q times qscale as it is loaded), 16-byte aligned; lse
// and delta [bh, s] f32, 16-byte aligned; dk and dv [bh, s, dh] f32.
// (rows, tile, stages, smem) name the plan (ops/attn.py:bwd_plan); another
// is refused.  Launches on `stream` and returns the launch's cudaError_t
// (0 on success).
extern "C" int t4_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int s, int dh, int causal, int parts,
                                int rows, int tile, int stages, int smem,
                                float qscale, void* stream) {
  if (bad_args(bh, s, dh, {q, k, v, dout, lse, delta}, {dk, dv}))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), bh, s, causal, qscale,
                  static_cast<cudaStream_t>(stream)};
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (parts == 0 && dh == FMA_D && fma_plan(true, rows, tile, stages, smem))
    return static_cast<int>(launch_dkv_fma(a, dkf, dvf));
#define T4_DKV(D, NP) \
  launch_sm90<D, NP>(a, true, dkf, dvf, 0.f, rows, tile, stages, smem)
  if (dh == 128 && parts == 3) return T4_DKV(128, 3);
  if (dh == 128 && parts == 1) return T4_DKV(128, 1);
  if (dh == 256 && parts == 1) return T4_DKV(256, 1);
#undef T4_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

// as above, dq [bh, s, dh] f32 = oscale * ds k
extern "C" int t4_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int s,
                               int dh, int causal, int parts, int rows,
                               int tile, int stages, int smem, float qscale,
                               float oscale, void* stream) {
  if (bad_args(bh, s, dh, {q, k, v, dout, lse, delta}, {dq}))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), bh, s, causal, qscale,
                  static_cast<cudaStream_t>(stream)};
  float* dqf = static_cast<float*>(dq);
  if (parts == 0 && dh == FMA_D && fma_plan(false, rows, tile, stages, smem))
    return static_cast<int>(launch_dq_fma(a, dqf, oscale));
#define T4_DQ(D, NP) \
  launch_sm90<D, NP>(a, false, dqf, nullptr, oscale, rows, tile, stages, smem)
  if (dh == 128 && parts == 3) return T4_DQ(128, 3);
  if (dh == 128 && parts == 1) return T4_DQ(128, 1);
  if (dh == 256 && parts == 1) return T4_DQ(256, 1);
#undef T4_DQ
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
