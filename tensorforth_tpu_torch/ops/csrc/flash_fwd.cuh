// The flash-attention forward's body for Hopper (sm_90a): its two products
// on the tensor cores through wgmma, fed by TMA.  Two kernels take it:
//   K1, flash_fwd.cu:  o = softmax(s2) v and lse, s2 = qscale (q k^T) in
//       the base-2 domain, the online softmax between the products;
//   K8, attn_dots.cu:  o = sum over the key tiles of bf16(q k^T) v, the
//       same body with the softmax compiled out (DOTS): no running max, no
//       exp2, no row sums, no rescale of o and no final division; p is the
//       raw s2 accumulator rounded to bf16 (cvt.rn), and no lse is written.
//
// Layout: q, k, v each [NP, B*h, S, dh] bf16 parts, row-major; o [B*h, S,
// dh] f32; lse [B*h, S] f32.  S % 64 == 0, dh 128 to 1024 in steps of 128
// (384 and wider: the f32 class on the cluster route of fwd_body, the bf16
// class, K1 hybrid and K8, on the wide route of fwd_wide_body below).
//
// The design.  A CTA of two warpgroups owns BQ query rows of one head; K
// and V stream through shared memory in BKV-row tiles (K and V in a ring
// of ST stages each), Q's parts stay for the whole CTA.  Thread 0 issues
// every TMA load (128-byte swizzle): Q's and the first ST tiles' before
// the loop, a K stage again once both warpgroups' score products have read
// it, a V stage once their PV products have.  Per KV tile a warpgroup:
//   s2 = Q K^T      m64nBKV over dh, Q (A) and K (B) K-major from the
//                   swizzled tiles, a fresh accumulator
//   online softmax  (K1 only) the running max, exp2 (ex2.approx: 2 ulp),
//                   the row sums and the rescale of o in f32 on the CUDA
//                   cores
//   pv = P V        m64n128 over the BKV keys, P from the s2 accumulator
//                   as bf16 A fragments in registers (split or rounded),
//                   V (B) MN-major: the transpose bit; a fresh accumulator
//                   added to o on the CUDA cores, whose adds round to
//                   nearest (the flush K5a does per slab)
// Shared memory in the f32 class (NP 3), all three parts of each operand:
//   dh 128: BQ 128 (each warpgroup 64 rows, all 128 columns of o), BKV
//     64: Q 96 KB + K 48 KB + V 48 KB = 192 KB, one stage each.  A second
//     stage (96 KB more) does not fit; 64 query rows a CTA would halve the
//     reuse of each K and V tile.  K's next tile loads while this tile's
//     softmax and PV run, V's while the next tile's scores run.
//   dh 256: BQ 64, BKV 32 (each warpgroup all 64 rows and 128 columns of
//     o; both form the scores): Q 96 KB + K 48 KB + V 48 KB.  Registers:
//     o alone is 128 a thread per 64 rows at dh 256, so the columns are
//     split between the warpgroups.
//   hybrid and the probe (NP 1): the same tiles in a third of the bytes,
//     two stages each.
//   dh 384 to 1024 in the f32 class (K1): a cluster of CL = dh / 128
//     CTAs per 128 query rows, each the dh-128 body over its 128 columns
//     of dh (the maps' boxes start at column 128 rank): Q 96 KB + K 48 KB
//     + V 48 KB in the f32 class, as at dh 128.  One CTA cannot hold them
//     (Q's three parts alone are 192 KB at dh 256), nor would a
//     warpgroup's 256
//     columns of o fit its registers.  Each CTA's s2 is a partial sum over
//     its columns; the cluster adds the partials through distributed
//     shared memory in two balanced rounds (sm90_gemm.cuh: Xrs, one 32 KB
//     slot a CTA and four barriers: each thread's 8 quads of s2 go to
//     their owners, which add the CL partials in cluster_sum's order, and
//     the owners' sums come back to every CTA), so
//     every CTA holds the same bits of s2, runs the same online softmax and
//     forms the same p, and does P V over its own columns of V and o.  Rank
//     0 writes lse.  A tile that a warpgroup's rows do not see still takes
//     part in the sum (as zeros), so every quad's owner hears from every
//     peer.
// Registers at dh 128, f32: o 64, the fresh PV accumulator 64, P's three
// parts 48 (the s2 accumulator, 32, dies as they form).
// The grid hands out the longest (last) causal query tiles first; a
// warpgroup skips the products of a KV tile its rows do not see, and only
// a tile that crosses its rows' diagonal tests the mask.
#pragma once

#include "sm90_gemm.cuh"
#include "split_bf16.cuh"

namespace {

constexpr int NT = 256;                  // two warpgroups; thread 0 loads
constexpr float NEG_INF = -1.0e30f;      // attn_pallas.py:25
constexpr float LN2 = 0.6931471805599453f;

// head dim D, NP parts of each operand, CL CTAs of a cluster that split dh
// (each holds DC = D / CL of its columns)
template <int D, int NP, int CL = 1>
struct Fwd {
  static constexpr int DC = D / CL;                 // a CTA's columns
  static constexpr int BQ = DC == 128 ? 128 : 64;   // query rows of a CTA
  static constexpr int BKV = DC == 128 ? 64 : 32;   // rows of a KV tile
  static constexpr int ST = NP == 1 ? 2 : 1;        // stages of K and of V
  static constexpr int NB = DC / 64;                // 128-byte column boxes
  static constexpr int QBOX = BQ * 128;             // a Q box [64 d x BQ]
  static constexpr int KBOX = BKV * 128;            // a K/V box [64 d x BKV]
  static constexpr int Q_PART = NB * QBOX;
  static constexpr int KV_PART = NB * KBOX;
  static constexpr int KV_BYTES = NP * KV_PART;     // a stage of K (or V)
  // a cluster's exchange slot: BKV / 2 floats of partial s2 for each
  // thread (Xrs's 8 quads at BKV 64); its barriers (Xrs with one slot:
  // two rounds' receipts and reads)
  static constexpr int XCH = CL > 1 ? NT * (BKV / 2) * 4 : 0;
  static constexpr int NBAR =
      1 + 2 * ST + (CL > 1 ? Xrs<CL < 3 ? 3 : CL, NT, 0, 1>::NBAR : 0);
  static constexpr int SMEM =
      ALIGN + NP * Q_PART + 2 * ST * KV_BYTES + XCH + NBAR * 8;
  static constexpr int ROWS_WG = DC == 128 ? 64 : 0;   // rows' offset by wg
  static constexpr int COLS_WG = DC == 128 ? 0 : 128;  // o columns' offset
  static constexpr int P0 = NP == 3 ? 0 : 5;   // first of prod_a/prod_b's
};
static_assert(Fwd<128, 3>::SMEM <= SMEM_LIMIT &&
                  Fwd<256, 3>::SMEM <= SMEM_LIMIT &&
                  Fwd<128, 1>::SMEM <= SMEM_LIMIT &&
                  Fwd<256, 1>::SMEM <= SMEM_LIMIT,
              "shared memory");
// K1's f32 class at dh 384 to 1024 on clusters of 3 to 8 CTAs: the dh-128
// tiles of the class, the slot and Xrs's four barriers more
static_assert(Fwd<384, 3, 3>::SMEM == 230456 &&
                  Fwd<512, 3, 4>::SMEM == 230456 &&
                  Fwd<640, 3, 5>::SMEM == 230456 &&
                  Fwd<768, 3, 6>::SMEM == 230456 &&
                  Fwd<896, 3, 7>::SMEM == 230456 &&
                  Fwd<1024, 3, 8>::SMEM == 230456 &&
                  Fwd<1024, 3, 8>::SMEM <= SMEM_LIMIT,
              "the f32 clusters' budget");
// Xrs's round-1 pool fits K1's slot (its 8 quads of s2: Xrs's own assert)
static_assert(Fwd<1024, 3, 8>::XCH == Xrs<8, NT, 0, 1>::SLOT_BYTES &&
                  Fwd<384, 3, 3>::XCH == Xrs<3, NT, 0, 1>::SLOT_BYTES,
              "an exchange slot");

// s2 (+)= A B^T over 16 of dh, m64nBKV, both K-major from shared memory
template <int BKV>
__device__ __forceinline__ void score_mma(float (&d)[BKV / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (BKV == 64)
    wgmma_64<0, 0>(d, da, db, scale_d);
  else
    wgmma_32<0, 0>(d, da, db, scale_d);
}

// one tile of an operand (the map's box of rows, from `row` on; NB boxes
// of 64 columns from column `col` on) in each of its NP parts, by TMA into
// shared memory at dst (part p at p part_bytes, its 64-column boxes
// box_bytes apart; part p's rows start p part_rows down the map), against
// `bar`; one thread issues them
template <int NB, int NP>
__device__ __forceinline__ void load_parts(uint32_t dst, uint32_t bar,
                                           const CUtensorMap* map,
                                           int part_rows, int row, int col,
                                           int part_bytes, int box_bytes) {
  mbar_expect_tx(bar, NP * part_bytes);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load(dst + p * part_bytes + b * box_bytes, map, bar, col + 64 * b,
               p * part_rows + row);
}

// the body of a kernel of NT threads over the maps of q, k and v (their
// parts' rows one after another) into o (and, unless DOTS, lse); smem_raw
// is the kernel's dynamic shared memory, Fwd<D, NP, CL>::SMEM bytes; CL 3
// to 8 (K1's f32 class): a CTA of a cluster of CL that split dh
template <int D, int NP, bool DOTS, int CL = 1>
__device__ __forceinline__ void fwd_body(unsigned char* smem_raw,
                                         const CUtensorMap* mq,
                                         const CUtensorMap* mk,
                                         const CUtensorMap* mv,
                                         float* __restrict__ o,
                                         float* __restrict__ lse, int S,
                                         int BH, int causal, float qscale) {
  using P = Fwd<D, NP, CL>;
  static_assert(CL == 1 || (CL >= 3 && P::BKV == 64), "Xrs's 8 quads");
  constexpr int BQ = P::BQ, BKV = P::BKV, ST = P::ST;
  constexpr int SA = BKV / 2;            // s2 accumulators a thread
  constexpr int NF = BKV / 4;            // P's A-fragment registers a part
  const uint32_t sQ = aligned_base(smem_raw);
  const uint32_t sK = sQ + NP * P::Q_PART;          // K stages, V stages
  const uint32_t sV = sK + ST * P::KV_BYTES;
  const uint32_t sX = sV + ST * P::KV_BYTES;        // a cluster's slot
  const uint32_t qfull = sX + P::XCH;               // then kfull[ST],
  const uint32_t kfull0 = qfull + 8;                // vfull[ST], a
  const uint32_t vfull0 = kfull0 + 8 * ST;          // cluster's got1, got2,
  const uint32_t xfull = vfull0 + 8 * ST;           // free1, free2

  // the CTA's rank in its cluster picks its columns, the cluster its rows
  const int rank = CL == 1 ? 0 : static_cast<int>(cluster_ctarank());
  const int col0 = rank * P::DC;
  const int blk = static_cast<int>(blockIdx.x / CL);
  // a cluster: this thread's place in the exchange slot
  [[maybe_unused]] const uint32_t xslot = sX + threadIdx.x * 16;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blk / BH;
  const int bh = blk % BH;
  const int q0 = qt * BQ;
  const int part_rows = BH * S;          // rows of one part in the maps
  const int row0 = bh * S;               // the head's first row
  const int n_kv = (causal ? min(q0 + BQ, S) : S) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
    }
    if constexpr (CL > 1) {
      T4_XRS(CL, NT, 1, xslot, xfull, xr.init())
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_parts<P::NB, NP>(sQ, qfull, mq, part_rows, row0 + q0, col0,
                          P::Q_PART, P::QBOX);
    for (int s = 0; s < ST && s < n_kv; ++s) {
      load_parts<P::NB, NP>(sK + s * P::KV_BYTES, kfull0 + 8 * s, mk,
                            part_rows, row0 + s * BKV, col0, P::KV_PART,
                            P::KBOX);
      load_parts<P::NB, NP>(sV + s * P::KV_BYTES, vfull0 + 8 * s, mv,
                            part_rows, row0 + s * BKV, col0, P::KV_PART,
                            P::KBOX);
    }
  }
  __syncthreads();
  // a cluster: the peers' exchange barriers are set up before any arrival
  if constexpr (CL > 1) cluster_sync();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qw = q0 + wg * P::ROWS_WG;   // the warpgroup's first query row
  const int dn = wg * P::COLS_WG;        // its columns of o
  const int fr = warp * 16 + g;          // its fragment rows fr and fr + 8
  const bool rows_in = qw < S;           // a Q tile past S has no query
  const uint32_t qa = sQ + wg * P::ROWS_WG * 128;   // A: its rows of Q

  float acc[64], pv[64], s[SA];
  [[maybe_unused]] float m_run[2] = {NEG_INF, NEG_INF};
  [[maybe_unused]] float l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(qfull, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % ST;
    const uint32_t phase = (j / ST) & 1;
    const int kv0 = j * BKV;
    const uint32_t sk = sK + st * P::KV_BYTES, sv = sV + st * P::KV_BYTES;
    // the warpgroup's rows see keys of this tile: its last row sees kv0
    const bool live = rows_in && (!causal || kv0 <= qw + 63);

    // ---- s2 = Q K^T [64 q x BKV kv] over dh, the class's products
    mbar_wait(kfull0 + 8 * st, phase);
    if (live) {
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int p = P::P0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < P::DC / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;   // 16 of dh in a box
          score_mma<BKV>(
              s,
              desc_a(qa + prod_a(p) * P::Q_PART + (kk / 4) * P::QBOX + col),
              desc_a(sk + prod_b(p) * P::KV_PART + (kk / 4) * P::KBOX + col),
              p > P::P0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
    }
    // both warpgroups are done with this K stage: it takes tile j + ST
    named_barrier(1, NT);
    if (threadIdx.x == 0 && j + ST < n_kv)
      load_parts<P::NB, NP>(sk, kfull0 + 8 * st, mk, part_rows,
                            row0 + (j + ST) * BKV, col0, P::KV_PART,
                            P::KBOX);
    // ---- a cluster: the partial s2 over the CTA's columns, summed over
    //      the cluster's (zeros where the rows see no key of the tile)
    if constexpr (CL > 1) {
      if (!live) {
#pragma unroll
        for (int i = 0; i < SA; ++i) s[i] = 0.f;
      }
      T4_XRS(CL, NT, 1, xslot, xfull, xr.sum(s, j, n_kv))
    }

    // ---- online softmax; element 4 jn + 2 i + c of s is query row
    //      qw + fr + 8 i, key kv0 + 8 jn + 2 t + c
    uint32_t pf[NP][NF];
    if (live) {
      if constexpr (!DOTS) {
        if (qscale != 1.f) {
#pragma unroll
          for (int x = 0; x < SA; ++x) s[x] *= qscale;
        }
        if (causal && kv0 + BKV - 1 > qw) {   // the tile crosses the diagonal
#pragma unroll
          for (int jn = 0; jn < BKV / 8; ++jn)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if (kv0 + 8 * jn + 2 * t + c > qw + fr + 8 * i)
                  s[4 * jn + 2 * i + c] = NEG_INF;
        }
        // every row saw key 0 in tile 0, so its running max is finite from
        // then on, and a masked score gives exp2(NEG_INF - m) = 0
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = NEG_INF;
#pragma unroll
          for (int jn = 0; jn < BKV / 8; ++jn)
            mx = fmaxf(mx, fmaxf(s[4 * jn + 2 * i], s[4 * jn + 2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[i], mx);
          const float alpha = ex2(m_run[i] - m_new);
          float rs = 0.f;
#pragma unroll
          for (int jn = 0; jn < BKV / 8; ++jn)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int x = 4 * jn + 2 * i + c;
              s[x] = ex2(s[x] - m_new);
              rs += s[x];
            }
          l_run[i] = l_run[i] * alpha + rs;   // this thread's share
          m_run[i] = m_new;
#pragma unroll
          for (int jn = 0; jn < 16; ++jn) {
            acc[4 * jn + 2 * i] *= alpha;
            acc[4 * jn + 2 * i + 1] *= alpha;
          }
        }
      }
      // P as bf16 A fragments of the k16 steps over the keys: step kk,
      // register u is elements 8 kk + 2 u, 8 kk + 2 u + 1
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        uint32_t w[NP];
        split_pair<NP>(s[2 * f], s[2 * f + 1], w);
#pragma unroll
        for (int p = 0; p < NP; ++p) pf[p][f] = w[p];
      }
    }

    // ---- pv = P V [64 q x 128 d] over the tile's keys, added to o
    mbar_wait(vfull0 + 8 * st, phase);
    if (live) {
      const uint64_t vb = desc_b(sv + (dn / 64) * P::KBOX, P::KBOX);
      pin(pv);
      wgmma_fence();
#pragma unroll
      for (int p = P::P0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint32_t* a = pf[prod_a(p)] + 4 * kk;
          wgmma_128_rs(pv, a[0], a[1], a[2], a[3],
                       vb + ((prod_b(p) * P::KV_PART) >> 4) + kk * 128,
                       p > P::P0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      pin(pv);
      // the products that read pf are done
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int f = 0; f < NF; ++f)
          asm volatile("" : "+r"(pf[p][f])::"memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += pv[i];
    }
    // both warpgroups are done with this V stage: it takes tile j + ST
    named_barrier(1, NT);
    if (threadIdx.x == 0 && j + ST < n_kv)
      load_parts<P::NB, NP>(sv, vfull0 + 8 * st, mv, part_rows,
                            row0 + (j + ST) * BKV, col0, P::KV_PART,
                            P::KBOX);
  }
  // a cluster: Xrs's readers await every message and leave the last
  // tile's reads unsignalled, so no access to this CTA's shared memory is
  // left
  if (!rows_in) return;

  // ---- flush: the row sum is spread over the 4 lanes of a row (DOTS: o
  //      as summed, no lse)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + fr + 8 * i;
    float* orow =
        o + (static_cast<size_t>(row0) + row) * D + col0 + dn + 2 * t;
    if constexpr (DOTS) {
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
        *reinterpret_cast<float2*>(orow + 8 * jn) =
            make_float2(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1]);
    } else {
      float lt = l_run[i];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
        *reinterpret_cast<float2*>(orow + 8 * jn) = make_float2(
            acc[4 * jn + 2 * i] / lt, acc[4 * jn + 2 * i + 1] / lt);
      if (t == 0 && (P::COLS_WG == 0 || wg == 0) && rank == 0)
        lse[static_cast<size_t>(row0) + row] = (m_run[i] + log2f(lt)) * LN2;
    }
  }
}

// the maps of q, k and v ([rows, d] bf16 each; boxes of 64 columns by bq
// rows for Q, bkv for K and V) into m[0..2]; 0 or a cudaError_t
inline int qkv_maps(const void* q, const void* k, const void* v, int rows,
                    int d, int bq, int bkv, CUtensorMap* m) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (!make_map(&m[0], fn, q, rows, d, d, 64, bq) ||
      !make_map(&m[1], fn, k, rows, d, d, 64, bkv) ||
      !make_map(&m[2], fn, v, rows, d, d, 64, bkv))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// the body's maps of q, k and v (every part's rows, NP bh s, in one map
// each; boxes of BQ and BKV rows) into m[0..2]; 0 or a cudaError_t
template <int D, int NP, int CL = 1>
int fwd_maps(const void* q, const void* k, const void* v, int bh, int s,
             CUtensorMap* m) {
  using P = Fwd<D, NP, CL>;
  return qkv_maps(q, k, v, NP * bh * s, D, P::BQ, P::BKV, m);
}

// the body's grid: a CTA per (head, BQ query rows), CL of them in a cluster
template <int D, int NP, int CL = 1>
dim3 fwd_grid(int bh, int s) {
  constexpr int BQ = Fwd<D, NP, CL>::BQ;
  return dim3(static_cast<unsigned>(CL * bh) * ((s + BQ - 1) / BQ));
}


// ---- the bf16 class at dh 384 to 1024: the wide route ----------------------
// K1 hybrid and K8 (NP 1).  dh is split between the warpgroups of one CTA,
// not between the CTAs of a cluster: warpgroup w owns the 128 columns 128 w
// of Q, K, V and o for the CTA's 64 query rows (the dh-128 body's slab), so
// a tile's partial scores meet in the CTA's own shared memory behind one
// named barrier.  At dh 384 and 512 one CTA of NW = dh / 128 warpgroups
// holds all of dh.  At dh 640 to 1024 one CTA's registers cannot hold o
// (64 a thread for each 128 columns), so a pair of CTAs takes the columns:
// rank 0 the first four blocks of 128, rank 1 the rest (its other
// warpgroups leave at once), and the pair adds its two CTA sums once a
// tile.  Per KV tile of 32 keys, each warpgroup:
//   s2_w = Q_w K_w^T  m64n32 over its 128 columns, a fresh accumulator,
//                     stored (float4 a thread) into its slot
//   s2 = the sum of the slots, read by every warpgroup, in the order of
//                     ops/attn.py:cluster_sum over the blocks of 128:
//                     x0 + x1, (x0 + x1) + x2, (x0 + x1) + (x2 + x3) in a
//                     CTA; the pair adds the CTA sums (A + B, commutative,
//                     the same bits in both), which at dh / 128 = 5 to 8
//                     blocks is cluster_sum's order again.  So s2 has the
//                     bits of the f32 class's cluster route and of what
//                     K2a, K2b and K3 re-form in the backward.
//   online softmax    (K1 only) as fwd_body's, in every warpgroup on the
//                     same bits (each holds the running max and row sums
//                     of all 64 rows, as o's rescale needs them)
//   o += P V_w        m64n128 over the 32 keys, P as bf16 A fragments in
//                     registers, accumulated into o by the tensor cores
//                     (scale_d 1, after the rescale): no fresh accumulator
// Every warpgroup reads every slot (an all-reduce) rather than a quarter
// of them: P then stays in registers for its A operand, and a tile takes
// two named barriers (slots written; slots and V read), not four.  The
// pair's message is the CTA sum of warpgroup 0's threads, st.async into
// the peer's slot (complete_tx on its `xfull`); the reader's thread 0
// arrives on the writer's `xfree` once the tile's last barrier says that
// every thread has read it.
// Shared memory (Wide<D>::SMEM): Q [64 x 128 NW] 16 KB a warpgroup, K two
// stages and V two (one in a pair, whose exchange slot then fits) of [32
// x 128 NW], a slot of 8 KB a warpgroup; the budgets are asserted below.
// Registers: o 64, s2 16, P 8 a thread at 128 NW threads (at most 512:
// 128 registers a thread).
template <int D>
struct Wide {
  static constexpr int NBLK = D / 128;              // blocks of 128 columns
  static constexpr int CL = NBLK > 4 ? 2 : 1;       // CTAs of the pair
  static constexpr int NW = NBLK > 4 ? 4 : NBLK;    // warpgroups of a CTA
  static constexpr int THREADS = 128 * NW;
  static constexpr int BQ = 64, BKV = 32;
  static constexpr int KST = 2;                     // stages of K
  static constexpr int VST = CL == 2 ? 1 : 2;       // ... and of V
  static constexpr int QBOX = BQ * 128;             // a Q box [64 d x BQ]
  static constexpr int KBOX = BKV * 128;            // a K/V box [64 d x BKV]
  static constexpr int Q_BYTES = 2 * NW * QBOX;
  static constexpr int KV_BYTES = 2 * NW * KBOX;    // a stage of K (or V)
  static constexpr int SLOT = 128 * (BKV / 2) * 4;  // a warpgroup's s2
  static constexpr int XCH = CL == 2 ? SLOT : 0;    // the pair's message
  static constexpr int NBAR = 1 + KST + VST + (CL == 2 ? 2 : 0);
  static constexpr int SMEM = ALIGN + Q_BYTES + (KST + VST) * KV_BYTES +
                              NW * SLOT + XCH + NBAR * 8;
};
static_assert(Wide<384>::SMEM == 173096 && Wide<512>::SMEM == 230440 &&
                  Wide<512>::SMEM <= SMEM_LIMIT,
              "the wide route's budget: one CTA");
static_assert(Wide<640>::SMEM == 205872 && Wide<768>::SMEM == 205872 &&
                  Wide<896>::SMEM == 205872 && Wide<1024>::SMEM == 205872,
              "the wide route's budget: a pair, one stage of V");

// nb boxes of 64 columns of a tile (rows from `row` on, columns from `col`
// on) by TMA into shared memory at dst, box_bytes apart, against `bar`
__device__ __forceinline__ void load_boxes(uint32_t dst, uint32_t bar,
                                           const CUtensorMap* map, int row,
                                           int col, int nb, int box_bytes) {
  mbar_expect_tx(bar, nb * box_bytes);
  for (int b = 0; b < nb; ++b)
    tma_load(dst + b * box_bytes, map, bar, col + 64 * b, row);
}

// the sum of the first n slots (1 to 4; this thread's float4 x of each at
// `at`, a slot apart) in cluster_sum's order, into s[4 x .. 4 x + 3]
template <int SLOT, int SA>
__device__ __forceinline__ void slots_sum(float (&s)[SA], uint32_t at,
                                          int n) {
#pragma unroll
  for (int x = 0; x < SA / 4; ++x) {
    const uint32_t a = at + x * 128 * 16;
    float4 u = ld_shared4(a);
    if (n >= 2) {
      const float4 w = ld_shared4(a + SLOT);
      u = make_float4(u.x + w.x, u.y + w.y, u.z + w.z, u.w + w.w);
    }
    if (n == 3) {
      const float4 w = ld_shared4(a + 2 * SLOT);
      u = make_float4(u.x + w.x, u.y + w.y, u.z + w.z, u.w + w.w);
    } else if (n == 4) {
      const float4 w = ld_shared4(a + 2 * SLOT);
      const float4 y = ld_shared4(a + 3 * SLOT);
      u = make_float4(u.x + (w.x + y.x), u.y + (w.y + y.y),
                      u.z + (w.z + y.z), u.w + (w.w + y.w));
    }
    s[4 * x] = u.x;
    s[4 * x + 1] = u.y;
    s[4 * x + 2] = u.z;
    s[4 * x + 3] = u.w;
  }
}

// the wide route's body for a kernel of Wide<D>::THREADS threads over the
// maps of q, k and v (bf16, boxes of 64 and 32 rows) into o (and, unless
// DOTS, lse); smem_raw is the kernel's dynamic shared memory,
// Wide<D>::SMEM bytes; at dh 640 to 1024 a CTA of a cluster of two
template <int D, bool DOTS>
__device__ __forceinline__ void fwd_wide_body(unsigned char* smem_raw,
                                              const CUtensorMap* mq,
                                              const CUtensorMap* mk,
                                              const CUtensorMap* mv,
                                              float* __restrict__ o,
                                              float* __restrict__ lse, int S,
                                              int BH, int causal,
                                              float qscale) {
  using W = Wide<D>;
  constexpr int BQ = W::BQ, BKV = W::BKV, KST = W::KST, VST = W::VST;
  constexpr int SA = BKV / 2;            // s2 accumulators a thread
  constexpr int NF = BKV / 4;            // P's A-fragment registers
  const uint32_t sQ = aligned_base(smem_raw);
  const uint32_t sK = sQ + W::Q_BYTES;              // K stages, V stages
  const uint32_t sV = sK + KST * W::KV_BYTES;
  const uint32_t sS = sV + VST * W::KV_BYTES;       // the warpgroups' slots
  const uint32_t sX = sS + W::NW * W::SLOT;         // the pair's message
  const uint32_t qfull = sX + W::XCH;               // then kfull[KST],
  const uint32_t kfull0 = qfull + 8;                // vfull[VST], and in a
  const uint32_t vfull0 = kfull0 + 8 * KST;         // pair xfull, xfree
  const uint32_t xfull = vfull0 + 8 * VST;
  [[maybe_unused]] const uint32_t xfree = xfull + 8;

  // the CTA's rank in its pair picks its blocks of columns
  const int rank = W::CL == 1 ? 0 : static_cast<int>(cluster_ctarank());
  const int nw = rank == 0 ? W::NW : W::NBLK - W::NW;   // its warpgroups
  const int col0 = rank * 128 * W::NW;
  const int blk = static_cast<int>(blockIdx.x / W::CL);
  const int n_qt = S / BQ;
  const int qt = n_qt - 1 - blk / BH;
  const int bh = blk % BH;
  const int q0 = qt * BQ;
  const int row0 = bh * S;               // the head's first row
  const int n_kv = (causal ? q0 + BQ : S) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < KST; ++s) mbar_init(kfull0 + 8 * s, 1);
    for (int s = 0; s < VST; ++s) mbar_init(vfull0 + 8 * s, 1);
    if constexpr (W::CL == 2) {
      mbar_init(xfull, 1);
      mbar_init(xfree, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_boxes(sQ, qfull, mq, row0 + q0, col0, 2 * nw, W::QBOX);
    for (int s = 0; s < KST && s < n_kv; ++s)
      load_boxes(sK + s * W::KV_BYTES, kfull0 + 8 * s, mk, row0 + s * BKV,
                 col0, 2 * nw, W::KBOX);
    for (int s = 0; s < VST && s < n_kv; ++s)
      load_boxes(sV + s * W::KV_BYTES, vfull0 + 8 * s, mv, row0 + s * BKV,
                 col0, 2 * nw, W::KBOX);
  }
  __syncthreads();
  // a pair: the peer's barriers are set up before any message
  if constexpr (W::CL == 2) cluster_sync();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg >= nw) return;                  // rank 1's spare warpgroups
  const int nth = 128 * nw;              // the threads of the barriers
  const int warp = tid / 32, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4;
  const int fr = warp * 16 + g;          // fragment rows fr and fr + 8
  const uint32_t qa = sQ + 2 * wg * W::QBOX;   // A: its columns of Q
  const uint32_t slot = sS + tid * 16;         // this thread's place in
  //                                              slot 0 (a slot apart on)
  [[maybe_unused]] const int peer = rank ^ 1;

  float acc[64], s[SA];
  [[maybe_unused]] float m_run[2] = {NEG_INF, NEG_INF};
  [[maybe_unused]] float l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(qfull, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int ks = j % KST, vs = j % VST;
    const int kv0 = j * BKV;
    const uint32_t sk = sK + ks * W::KV_BYTES, sv = sV + vs * W::KV_BYTES;

    // ---- the partial s2 = Q_w K_w^T [64 q x 32 kv] over its 128 columns
    mbar_wait(kfull0 + 8 * ks, (j / KST) & 1);
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t col = (kk % 4) * 32;   // 16 of dh in a box
      wgmma_32<0, 0>(s, desc_a(qa + (kk / 4) * W::QBOX + col),
                     desc_a(sk + (2 * wg + kk / 4) * W::KBOX + col), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
#pragma unroll
    for (int x = 0; x < SA / 4; ++x)
      st_shared4(slot + wg * W::SLOT + x * 128 * 16, s[4 * x], s[4 * x + 1],
                 s[4 * x + 2], s[4 * x + 3]);
    // every partial is in its slot, and every warpgroup is done with this K
    // stage: it takes tile j + KST
    named_barrier(1, nth);
    if (threadIdx.x == 0 && j + KST < n_kv)
      load_boxes(sk, kfull0 + 8 * ks, mk, row0 + (j + KST) * BKV, col0,
                 2 * nw, W::KBOX);
    // ---- the CTA's sum, then a pair's: the other CTA's sum added once
    slots_sum<W::SLOT>(s, slot, nw);
    if constexpr (W::CL == 2) {
      if (threadIdx.x == 0) mbar_expect_tx(xfull, W::SLOT);
      if (wg == 0) {
        if (j > 0) mbar_wait<true>(xfree, (j - 1) & 1);
        push<128>(s, cluster_addr(sX + tid * 16, peer),
                  cluster_addr(xfull, peer));
      }
      mbar_wait<true>(xfull, j & 1);
      add_peer<128>(s, sX + tid * 16);
    }

    // ---- online softmax; element 4 jn + 2 i + c of s is query row
    //      q0 + fr + 8 i, key kv0 + 8 jn + 2 t + c
    if constexpr (!DOTS) {
      if (qscale != 1.f) {
#pragma unroll
        for (int x = 0; x < SA; ++x) s[x] *= qscale;
      }
      if (causal && kv0 + BKV - 1 > q0) {   // the tile crosses the diagonal
#pragma unroll
        for (int jn = 0; jn < BKV / 8; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (kv0 + 8 * jn + 2 * t + c > q0 + fr + 8 * i)
                s[4 * jn + 2 * i + c] = NEG_INF;
      }
      // every row saw key 0 in tile 0, so its running max is finite from
      // then on, and a masked score gives exp2(NEG_INF - m) = 0
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int jn = 0; jn < BKV / 8; ++jn)
          mx = fmaxf(mx, fmaxf(s[4 * jn + 2 * i], s[4 * jn + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        const float alpha = ex2(m_run[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int jn = 0; jn < BKV / 8; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * jn + 2 * i + c;
            s[x] = ex2(s[x] - m_new);
            rs += s[x];
          }
        l_run[i] = l_run[i] * alpha + rs;   // this thread's share
        m_run[i] = m_new;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          acc[4 * jn + 2 * i] *= alpha;
          acc[4 * jn + 2 * i + 1] *= alpha;
        }
      }
    }
    // P as bf16 A fragments of the k16 steps over the keys: step kk,
    // register u is elements 8 kk + 2 u, 8 kk + 2 u + 1
    uint32_t pf[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) pf[f] = pack_bf16(s[2 * f], s[2 * f + 1]);

    // ---- o += P V_w [64 q x 128 d] over the tile's keys
    mbar_wait(vfull0 + 8 * vs, (j / VST) & 1);
    {
      const uint64_t vb = desc_b(sv + 2 * wg * W::KBOX, W::KBOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_128_rs(acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                     pf[4 * kk + 3], vb + kk * 128, 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      // the products that read pf are done
#pragma unroll
      for (int f = 0; f < NF; ++f)
        asm volatile("" : "+r"(pf[f])::"memory");
    }
    // every warpgroup is done with this V stage (it takes tile j + VST),
    // with the slots and with the pair's message (the peer may send again)
    named_barrier(1, nth);
    if (threadIdx.x == 0) {
      if (j + VST < n_kv)
        load_boxes(sv, vfull0 + 8 * vs, mv, row0 + (j + VST) * BKV, col0,
                   2 * nw, W::KBOX);
      if constexpr (W::CL == 2) mbar_arrive_remote(cluster_addr(xfree, peer));
    }
  }
  // a pair: the peer has arrived on xfree for the last time, so no access
  // to this CTA's shared memory is left
  if constexpr (W::CL == 2) mbar_wait<true>(xfree, (n_kv - 1) & 1);

  // ---- flush: the row sum is spread over the 4 lanes of a row (DOTS: o
  //      as summed, no lse)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + fr + 8 * i;
    float* orow = o + (static_cast<size_t>(row0) + row) * D + col0 +
                  128 * wg + 2 * t;
    if constexpr (DOTS) {
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
        *reinterpret_cast<float2*>(orow + 8 * jn) =
            make_float2(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1]);
    } else {
      float lt = l_run[i];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
        *reinterpret_cast<float2*>(orow + 8 * jn) = make_float2(
            acc[4 * jn + 2 * i] / lt, acc[4 * jn + 2 * i + 1] / lt);
      if (t == 0 && wg == 0 && rank == 0)
        lse[static_cast<size_t>(row0) + row] = (m_run[i] + log2f(lt)) * LN2;
    }
  }
}

// the wide route's maps of q, k and v (bf16 [bh s, D]; boxes of 64 rows
// for Q, 32 for K and V) into m[0..2]; 0 or a cudaError_t
template <int D>
int wide_maps(const void* q, const void* k, const void* v, int bh, int s,
              CUtensorMap* m) {
  return qkv_maps(q, k, v, bh * s, D, Wide<D>::BQ, Wide<D>::BKV, m);
}

// the wide route's grid: a CTA (a pair at dh 640 to 1024) per (head, 64
// query rows)
template <int D>
dim3 wide_grid(int bh, int s) {
  return dim3(static_cast<unsigned>(Wide<D>::CL * bh) * (s / Wide<D>::BQ));
}

}  // namespace
