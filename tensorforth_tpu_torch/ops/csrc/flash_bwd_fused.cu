// Flash-attention backward for Hopper (sm_90a) in ONE kernel launch: dQ, dK
// and dV with five products per visited (Q tile, KV tile) pair.
//
// Replaces tensorforth_tpu/ops/attn_pallas.py:_flash_bwd_fused_kernel (line
// 475; launched by flash_attention_bwd_fused, call at 574).  The arithmetic
// is that of flash_bwd.cu (see its header), but s2 = q2 k^T and dp = do v^T
// are computed once per pair and feed all three gradients, where the
// two-kernel split computes them in both kernels (seven products):
//   p = exp2(s2 - lse2),  ds = p * (dp - delta)
//   dq += ds k,   dv_part = p^T do,   dk_part = ln2 * ds^T q2
// The function is the TPU kernel's: dK and dV leave as per-Q-block partials
// [B*h, n_q, S, dh] f32 (n_q = S / bq, bq the caller's), each the sum over
// its Q block's rows, and one sum over n_q outside the kernel turns them
// into dK and dV.  Rows of a partial that its Q block never sees (the keys
// after the block, under the causal mask) are zeros.
//
// Layout: q, k, v, do [B*h, S, dh] row-major (bf16 casts in hybrid mode;
// in the f32 class three bf16 parts [3, B*h, S, dh] of q*scale*log2e, k, v
// and do); lse, delta [B*h, S] f32; dq partials [n_slots, B*h, S, dh] f32;
// dkp, dvp [B*h, n_q, S, dh] f32.  S % bq == 0, bq % 64 == 0, dh 128 to
// 1024 in steps of 128 (1152 and wider are refused: a cluster of 9+ CTAs
// is past the 8 of a portable cluster).
//
// What bounds it on this card: operations, but for the partials' bytes.
//   hybrid (bf16 multiplicands, f32 sums), at [16, 2048, 128] causal, bq
//     1024: the five products are 42.97 GFLOP, 0.043 ms at the 989 TFLOP/s
//     of bf16 wgmma; the bytes (bf16 operands, the dK/dV partials written
//     and read by the sums, dq, dk, dv) are 218 MB, 0.065 ms at 3.35 TB/s.
//     The bytes bound it, and the partials are 134 MB of them.
//   f32, dh 128, at [64, 2048, 128] causal, bq 1024: six bf16 products of
//     the three-part split (as the split's kernels, flash_bwd.cu), 6 x
//     171.9 GFLOP, 1.04 ms at 989 TFLOP/s; the partials add 268 MB written
//     and read, 0.16 ms.  Three bf16 products (K5a 3pass's) cannot hold
//     this class's fused-equals-split bound of 1e-5 + 1e-5 |x|: their
//     products alone, summed exactly, miss it by up to 2.8 times
//     (tests/test_torch_attn_fused_sm90.py); six keep it
//     (tests/test_torch_fused6.py).
//   f32, dh 256, at [32, 2048, 256] causal, bq 1024: the same six
//     products over the same 171.9 GFLOP, 1.04 ms; three parts of its
//     tiles do not fit a block's 227 KB, so a cluster of two CTAs splits
//     dh (below), and the two halves of s2 and dp cross between them.
//   dh 384 to 1024, both classes, at [16, 2048, dh] causal, bq 1024: the
//     same work per (query, key) pair times dh / 128, on clusters of dh /
//     128 CTAs (below); at dh 1024 the f32 class's six products are 6 x
//     171.9 GFLOP again, 1.04 ms, the hybrid class's one 0.17 ms, which
//     the partials' 268 MB (0.08 ms) do not reach.
//
// The design.  One CTA (a cluster of two at dh 256 in the f32 class) owns
// a work item (head, Q block, KV chunk): a run of `chunk` KV tiles of one
// head, against the Q tiles of one Q block that see them.  The host plans
// the items (ops/attn.py:fused_plan): it picks the longest chunk that
// still gives every SM a CTA with work (every cluster slot a pair), or one
// tile, whatever bq is, and lists the items heaviest first, since the
// causal load differs from item to item.  Inside a CTA the order is KV tile
// (outer) -> the Q block's 64-row tiles (inner): K and V stay in
// shared memory and the tile's dK/dV rows stay in registers across the
// inner loop, so a partial row is stored once, by one thread.  dq cannot
// stay: its rows get sums from every chunk.  Each chunk writes its own dq
// partial (a `slot`; the first KV tile of the chunk stores, the later ones
// load, add and store the same elements in the same thread), and the
// wrapper sums the slots.  So EVERY OUTPUT ELEMENT HAS ONE WRITER, or is
// summed in a fixed order: no atomics, and runs repeat to the bit.  A
// chunk that its Q block never sees, and the Q tiles that see none of a
// chunk, write zeros to their rows.
//
// hybrid, fused_sm90_kernel: 256 threads, two warpgroups that compute with
// bf16 wgmma and f32 sums; thread 0 also issues the TMA loads (128-byte
// swizzle): the KV tile's K and V (a `kvfull` barrier) and each Q tile's Q,
// dO, lse and delta into a ring of stages (3 at dh 128, 2 at dh 256; a
// `full` barrier each), so the next tiles' loads are in flight while this
// one computes.  At dh 128 the KV tile has 128 rows and each warpgroup owns
// 64 of them; at dh 256 it has 64 rows, and each warpgroup owns half of the
// dK/dV columns (both form s2 and dp, whose 64 x 64 tiles they need as A
// operands).  Per pair:
//   s2^T = K Q^T, dp^T = V dO^T     m64n64, K and V (A) and Q and dO (B)
//                                   K-major from the swizzled tiles
//   p, ds in the accumulators       then packed to bf16 A fragments
//   dv += p^T dO, dk += ds^T q2     m64n128, A from registers, B MN-major
//   dq += ds K                      m64n64 per 64 columns, ds^T (bf16,
//                                   written to a swizzled tile) read
//                                   transposed as A, K MN-major as B
// p and ds round to bf16 (cvt.rn) before their products, ds is formed from
// the unrounded p, as flash_bwd.cu and the plain version do; the products
// are exact and summed in f32 (exp2 by ex2.approx; only the tiles that
// cross the diagonal or S test the mask).  One barrier of the 256 threads
// a pair: the ds^T tile is whole (two tiles in turn), and the previous
// pair's stage is free for thread 0 to refill.  A pair's dq rows of an
// earlier tile of the chunk are prefetched into L1 when the pair starts.
//
// f32 at dh 128, fused_f32_sm90_kernel<1>: the same data flow on the three
// parts of each operand, six products each (its notes below).  Shared
// memory: K's and V's parts 96 KB, one stage of Q's and dO's 96 KB, ds^T's
// three parts 24 KB, lse and delta: 218 KB of a block's 227 KB.
//
// f32 at dh 256, fused_f32_sm90_kernel<2>: the dh-128 body on a cluster
// of two CTAs that split dh, as flash_bwd.cu's cluster route does.  Each
// CTA of a pair owns the same item and holds F6's tiles over its 128
// columns (its maps' boxes start at column 128 rank), so its s2^T and
// dp^T are partial sums over half of dh.  Per pair each thread pushes its
// 32 partial floats into its twin's slot in the peer CTA (mapa, st.async,
// the bytes completing on the peer's `full` barrier; dp's while s2's
// products run), then adds its twin's partials in f32: the same bits in
// both CTAs, so p and ds are equal in both.  dv, dk and dq then run over
// the CTA's own columns, and every output element keeps one writer.  The
// budget: F6's tiles, the 32 KB of slots, lse and delta and five barriers
// are 230,952 of 232,448 bytes only because ds^T's three parts (24 KB)
// live in the slots: a CTA writes them once every thread has read its
// twin's partials (the pair's barrier before the ds^T stores), and
// arrives on the peer's `empty` barrier, which lets the peer push the next
// pair, only once its dq products, the last readers of ds^T, are done.
// dh 384 to 1024, both classes, the split body on clusters of CL = dh /
// 128 CTAs (fused_f32_sm90_kernel<CL>, fused_hybrid_sm90_kernel<CL>): each
// CTA holds the dh-128 tiles of its class over its 128 columns (the hybrid
// class one part of each, K's and V's space kept at the 64 KB that
// warpgroup 1's dk and dv pass through), and the partial s2 and dp are
// summed through sm90_gemm.cuh's Xrs, the two balanced rounds of K2a and
// K2b (a reduce-scatter of each thread's 8 quads to their owners, which
// add the CL partials in cluster_sum's order, then an all-gather of the
// sums), so p and ds are the same bits in every CTA.  The f32 class has
// one 32 KB slot, which takes both rounds in turn, then ds^T's parts: a
// CTA writes them once every thread has read round 2 (the pair's barrier
// before the stores), and signals that read (Xrs::read, which lets its
// peers send the next pair's round 1) only once its dq products, the last
// readers of ds^T, are done: the dh-256 route's budget with two barriers
// more, 230,968 bytes.  The hybrid class has the room for two slots (one
// a round: no sender waits) and ds^T's part in a place of its own:
// 173,608 bytes.  At CL 2 the exchange is Xch's pair.
// ops/attn.py:fused_plan picks the route from dh and the class, and counts
// a cluster of CL SMs a slot.

#include "flash_tile.cuh"
#include "sm90_gemm.cuh"
#include "split_bf16.cuh"

namespace {

constexpr int QT = 64;       // rows of a Q tile (both kernels)

// one CTA's work item: its head, Q block and KV chunk, from the plan's list
// (items[2 i], items[2 i + 1] = Q block, chunk; every head of item i
// before any of item i + 1); the CL CTAs of a cluster share one
struct Item {
  int bh, qi, c;
};

template <int CL = 1>
__device__ __forceinline__ Item item_of(const int* items, int BH) {
  const int blk = static_cast<int>(blockIdx.x / CL);
  const int i = blk / BH;
  return {blk % BH, items[2 * i], items[2 * i + 1]};
}

// the first Q tile (its first row) of the block at qb0 that sees keys from
// kv0 on: under the causal mask, tile q0 sees key kv0 when kv0 <= q0 + 63
__device__ __forceinline__ int q_first(int qb0, int kv0, int causal) {
  return causal ? max(qb0, kv0 / QT * QT) : qb0;
}

// `rows` rows of D floats from p (16-byte aligned), their W columns from
// col0 on (W % 4 == 0), set to zero by `threads` threads, this one being
// `tid`
template <int D, int W>
__device__ __forceinline__ void zero_rows(float* p, int rows, int col0,
                                          int tid, int threads) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = tid; i < (size_t)rows * (W / 4); i += threads)
    *reinterpret_cast<float4*>(p + i / (W / 4) * D + col0 +
                               i % (W / 4) * 4) = z;
}

// the rows of an item that no pair writes, set to zero over the CTA's W
// columns from col0 on (all D unless a cluster splits dh): the rows
// [kz0, kz1) of both partial slabs (keys of the chunk that the Q block
// never sees) and the rows [qb0, qz1) of the chunk's dq slot (Q tiles that
// see no key of the chunk)
template <int D, int W = D>
__device__ __forceinline__ void zero_unseen(float* dkp, float* dvp,
                                            float* dq_slot, size_t part,
                                            int kz0, int kz1, int qb0,
                                            int qz1, int tid, int threads,
                                            int col0 = 0) {
  if (kz1 > kz0) {
    zero_rows<D, W>(dkp + (part + kz0) * D, kz1 - kz0, col0, tid, threads);
    zero_rows<D, W>(dvp + (part + kz0) * D, kz1 - kz0, col0, tid, threads);
  }
  if (qz1 > qb0)
    zero_rows<D, W>(dq_slot + (size_t)qb0 * D, qz1 - qb0, col0, tid,
                    threads);
}

// ===========================================================================
// hybrid: bf16 wgmma
// ===========================================================================
constexpr int HT = 256;      // two warpgroups; thread 0 also issues the loads

template <int D>
struct Hy {
  static constexpr int BKV = D == 128 ? 128 : 64;  // KV tile rows
  static constexpr int NB = D / 64;         // 64-column (128-byte) boxes
  static constexpr int KBOX = BKV * 128;    // a K or V box [64 d x BKV]
  static constexpr int QBOX = QT * 128;     // a Q or dO box [64 d x 64]
  static constexpr int KV_BYTES = NB * KBOX;
  static constexpr int Q_BYTES = NB * QBOX;
  static constexpr int DS_BYTES = BKV * 128;  // ds^T [BKV x 64] bf16
  static constexpr int NS = D == 128 ? 3 : 2; // stages of the Q-side ring
  // a stage: Q, dO, then lse and delta of the tile's rows; the next stage
  // starts 1024-aligned
  static constexpr int STAGE_TX = 2 * Q_BYTES + 2 * QT * 4;
  static constexpr int STAGE = 2 * Q_BYTES + ALIGN;
  static constexpr int SMEM =
      ALIGN + 2 * KV_BYTES + 2 * DS_BYTES + NS * STAGE + (NS + 1) * 8;
  static constexpr int ROWS_WG = D == 128 ? 64 : 0;  // KV rows' offset by wg
  static constexpr int COLS_WG = D == 128 ? 0 : 128; // dK/dV columns' offset
};
static_assert(Hy<128>::SMEM <= SMEM_LIMIT && Hy<256>::SMEM <= SMEM_LIMIT,
              "shared memory");

// the pairs of an item in the order the CTA computes them: KV tile j from
// j0 to jv - 1 (outer), the Q tiles q0 of the block that see it (inner)
struct Pairs {
  int j, q0, qb0, qb1, jv, bkv, causal;
  __device__ __forceinline__ bool done() const { return j >= jv; }
  __device__ __forceinline__ void next() {
    q0 += QT;
    if (q0 >= qb1) {
      ++j;
      q0 = q_first(qb0, j * bkv, causal);
    }
  }
};

// the Q-side tiles of the pair at q0 (Q, dO, lse, delta) by TMA into the
// stage at sq, against its `full` barrier; one thread issues them
template <int D>
__device__ __forceinline__ void load_stage(uint32_t sq, uint32_t full,
                                           const CUtensorMap* mq,
                                           const CUtensorMap* mo,
                                           const float* lse,
                                           const float* delta, int row) {
  using P = Hy<D>;
  mbar_expect_tx(full, P::STAGE_TX);
  for (int b = 0; b < P::NB; ++b) {
    tma_load(sq + b * P::QBOX, mq, full, 64 * b, row);
    tma_load(sq + P::Q_BYTES + b * P::QBOX, mo, full, 64 * b, row);
  }
  bulk_load(sq + 2 * P::Q_BYTES, lse + row, QT * 4, full);
  bulk_load(sq + 2 * P::Q_BYTES + QT * 4, delta + row, QT * 4, full);
}

// K and V of KV tile j by TMA, against `kvfull`; one thread issues them
template <int D>
__device__ __forceinline__ void load_kv(uint32_t sK, uint32_t sV,
                                        uint32_t kvfull,
                                        const CUtensorMap* mk,
                                        const CUtensorMap* mv, int row) {
  using P = Hy<D>;
  mbar_expect_tx(kvfull, 2 * P::KV_BYTES);
  for (int b = 0; b < P::NB; ++b) {
    tma_load(sK + b * P::KBOX, mk, kvfull, 64 * b, row);
    tma_load(sV + b * P::KBOX, mv, kvfull, 64 * b, row);
  }
}

// p = exp2(s2 - lse2) and ds = p (dp - delta) in place of the s2^T and
// dp^T accumulators of an m64nN product (N / 2 of them a thread): element
// 4 jn + 2 i + c is key row kv + 8 i, query column q0 + 8 jn + 2 t + c,
// whose lse and delta are Ls[8 jn + 2 t + c] and Es[...].  MASK: keys past
// S, and under the causal mask keys after the query, give p = 0.
template <bool MASK, int N>
__device__ __forceinline__ void softmax_grad_frag(float (&s)[N],
                                                  float (&dp)[N],
                                                  const float* Ls,
                                                  const float* Es, int kv,
                                                  int q0, int S, int causal,
                                                  int t) {
#pragma unroll
  for (int jn = 0; jn < N / 4; ++jn) {
    const int qc = 8 * jn + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(Ls + qc);
    const float2 e = *reinterpret_cast<const float2*>(Es + qc);
    const float l2[2] = {l.x * LOG2E, l.y * LOG2E}, de[2] = {e.x, e.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int x = 4 * jn + 2 * i + c;
        float p = ex2(s[x] - l2[c]);
        if (MASK && (kv + 8 * i >= S || (causal && kv + 8 * i > q0 + qc + c)))
          p = 0.f;
        dp[x] = p * (dp[x] - de[c]);
        s[x] = p;
      }
  }
}

// two warpgroups and no producer warp: 8 warps, two on each of the SM's
// four register files, so that a thread may hold 255 registers (a ninth
// warp would cap them at 168, below the 192 of dK, dV, s2 and dp).  Thread
// 0 issues the TMA loads: the first NS stages and the first K and V before
// the loop, a stage again once the per-pair barrier proves it read, K and
// V again once the KV tile's last pair is done.
template <int D>
__global__ void __launch_bounds__(HT, 1)
    fused_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dqp, float* __restrict__ dkp,
                      float* __restrict__ dvp, const int* __restrict__ items,
                      int S, int BH, int bq, int chunk, int causal,
                      float oscale) {
  using P = Hy<D>;
  constexpr int BKV = P::BKV, NS = P::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = sK + P::KV_BYTES;
  const uint32_t sDS = sV + P::KV_BYTES;           // two ds^T tiles in turn
  const uint32_t sST = sDS + 2 * P::DS_BYTES;      // the stages
  const uint32_t full0 = sST + NS * P::STAGE;      // full[NS], kvfull
  const uint32_t kvfull = full0 + 8 * NS;

  const Item w = item_of(items, BH);
  const int n_q = S / bq, n_kv = (S + BKV - 1) / BKV;
  const int qb0 = w.qi * bq, qb1 = qb0 + bq;
  const int j0 = w.c * chunk, j1 = min(j0 + chunk, n_kv);
  // the chunk's visited tiles are j0 .. jv-1: the Q block sees keys below
  // kv_vis
  const int kv_vis = causal ? qb1 : S;
  const int jv = max(j0, min(j1, (kv_vis + BKV - 1) / BKV));
  const int row0 = w.bh * S;                       // the head in the maps

  // the loads' cursor (thread 0's): the next pair whose stage is to load
  Pairs ld{j0, q_first(qb0, j0 * BKV, causal), qb0, qb1, jv, BKV, causal};
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init(kvfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (jv > j0) load_kv<D>(sK, sV, kvfull, &mk, &mv, row0 + j0 * BKV);
    for (int s = 0; s < NS && !ld.done(); ++s, ld.next())
      load_stage<D>(sST + s * P::STAGE, full0 + 8 * s, &mq, &mo, lse, delta,
                    row0 + ld.q0);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = wg * P::ROWS_WG;     // this warpgroup's KV rows in the tile
  const int dn = wg * P::COLS_WG;     // its dK/dV columns
  const int fr = warp * 16 + g;       // its fragment rows fr and fr + 8
  // ds^T rows: each warpgroup writes its own; at dh 256 both hold all 64,
  // and warps 0, 1 of warpgroup 0 and 2, 3 of warpgroup 1 write them
  const bool writes_ds = D == 128 || warp / 2 == wg;
  const size_t part = ((size_t)w.bh * n_q + w.qi) * S;   // partial rows
  float* dq_slot = dqp + ((size_t)w.c * BH + w.bh) * S * D;
  // descriptors of the K and V tiles, this warpgroup's rows, K-major (A of
  // s2^T and dp^T); a step is an offset in 16-byte units
  const uint64_t dk_a = desc_a(sK + r0 * 128), dv_a = desc_a(sV + r0 * 128);

  float acc_s[32], acc_p[32], dk[64], dv[64], acc_q[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_s[i] = acc_p[i] = 0.f;
  int it = 0;
  for (int j = j0; j < jv; ++j) {
    const int kv0 = j * BKV;
    mbar_wait(kvfull, (j - j0) & 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    for (int q0 = q_first(qb0, kv0, causal); q0 < qb1; q0 += QT, ++it) {
      const int st = it % NS;
      mbar_wait(full0 + 8 * st, (it / NS) & 1);
      const uint32_t sq = sST + st * P::STAGE, so = sq + P::Q_BYTES;
      const float* Ls =
          reinterpret_cast<const float*>(gbase + (sq - base) + 2 * P::Q_BYTES);
      const float* Es = Ls + QT;
      if (j > j0) {
        // this pair's dq rows, to be loaded after its other products: into
        // L1 now, while those run
#pragma unroll
        for (int pc = 0; pc < D / 128; ++pc) {
          const int dc = D == 128 ? 64 * wg : 128 * wg + 64 * pc;
          const float* rowp = dq_slot + (size_t)(q0 + fr) * D + dc;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            asm volatile("prefetch.global.L1 [%0];" ::"l"(
                rowp + (u / 2) * 8 * D + (u % 2) * 32));
        }
      }

      // s2^T and dp^T [64 kv x 64 q] over D
      const uint64_t dq_b = desc_a(sq), do_b = desc_a(so);
      pin(acc_s);
      pin(acc_p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = ((kk / 4) * P::KBOX + (kk % 4) * 32) >> 4;
        const uint32_t qo = ((kk / 4) * P::QBOX + (kk % 4) * 32) >> 4;
        wgmma_64<0, 0>(acc_s, dk_a + ko, dq_b + qo, kk > 0);
        wgmma_64<0, 0>(acc_p, dv_a + ko, do_b + qo, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_s);
      pin(acc_p);

      // p and ds in place; only a tile that crosses the diagonal or S masks
      if ((causal && kv0 + r0 + 63 > q0) || kv0 + r0 + 64 > S)
        softmax_grad_frag<true>(acc_s, acc_p, Ls, Es, kv0 + r0 + fr, q0, S,
                                causal, t);
      else
        softmax_grad_frag<false>(acc_s, acc_p, Ls, Es, kv0 + r0 + fr, q0, S,
                                 causal, t);
      // both as bf16 A fragments of the k16 steps over q: step kk, a_u is
      // elements 8 kk + 2 u, 8 kk + 2 u + 1
      uint32_t pa[16], da[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pa[i] = pack_bf16(acc_s[2 * i], acc_s[2 * i + 1]);
        da[i] = pack_bf16(acc_p[2 * i], acc_p[2 * i + 1]);
      }
      // ds^T into the swizzled tile that the dq product reads: row = key,
      // 64 queries (128 bytes) a row, 16-byte unit u of row r at u ^ (r % 8)
      const uint32_t sds = sDS + (it & 1) * P::DS_BYTES;
      if (writes_ds) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = r0 + fr + 8 * i;
            const uint32_t at =
                sds + r * 128 + ((jn ^ (r & 7)) << 4) + 4 * t;
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                         "r"(da[2 * jn + i])
                         : "memory");
          }
      }

      // dv += p^T dO, dk += ds^T q2: [64 kv x 128 d] over the 64 queries
      const uint64_t do_mn = desc_b(so + (dn / 64) * P::QBOX, P::QBOX);
      const uint64_t q_mn = desc_b(sq + (dn / 64) * P::QBOX, P::QBOX);
      pin(dv);
      pin(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_128_rs(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3], do_mn + kk * 128, 1);
        wgmma_128_rs(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                     da[4 * kk + 3], q_mn + kk * 128, 1);
      }
      wgmma_commit();
      pin(dv);
      pin(dk);
      fence_proxy_async();
      // the ds^T tile is whole, and every thread is done with the previous
      // pair: its stage takes the loads of the pair NS - 1 ahead of this one
      named_barrier(1, HT);
      if (threadIdx.x == 0 && it > 0 && !ld.done()) {
        const int sp = (it - 1) % NS;
        load_stage<D>(sST + sp * P::STAGE, full0 + 8 * sp, &mq, &mo, lse,
                      delta, row0 + ld.q0);
        ld.next();
      }
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      // the products that read pa and da are done
#pragma unroll
      for (int i = 0; i < 16; ++i)
        asm volatile("" : "+r"(pa[i]), "+r"(da[i])::"memory");

      // dq rows q0.. of the chunk's slot += ds K, 64 columns at a time: the
      // chunk's first tile stores, the others load, add and store; the last
      // tile that the Q tile sees in the chunk scales by oscale
      const int last = causal ? min(jv - 1, (q0 + QT - 1) / BKV) : jv - 1;
      const float scale = j == last ? oscale : 1.f;
      const uint64_t ds_mn = desc_b(sds, P::DS_BYTES);
#pragma unroll
      for (int pc = 0; pc < D / 128; ++pc) {
        const int dc = D == 128 ? 64 * wg : 128 * wg + 64 * pc;
        const uint64_t k_mn = desc_b(sK + (dc / 64) * P::KBOX, P::KBOX);
        float* rowp = dq_slot + (size_t)(q0 + fr) * D + dc + 2 * t;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float2 v = make_float2(0.f, 0.f);
            if (j > j0)
              v = *reinterpret_cast<const float2*>(rowp + 8 * i * D + 8 * jn);
            acc_q[4 * jn + 2 * i] = v.x;
            acc_q[4 * jn + 2 * i + 1] = v.y;
          }
        pin(acc_q);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_64<1, 1>(acc_q, ds_mn + kk * 128, k_mn + kk * 128, 1);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc_q);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(rowp + 8 * i * D + 8 * jn) =
                make_float2(acc_q[4 * jn + 2 * i] * scale,
                            acc_q[4 * jn + 2 * i + 1] * scale);
      }
    }
    if (j + 1 < jv) {
      // every product that reads K and V is done: the next tile's loads
      // run beside this tile's stores
      named_barrier(1, HT);
      if (threadIdx.x == 0)
        load_kv<D>(sK, sV, kvfull, &mk, &mv, row0 + (j + 1) * BKV);
    }
    // this KV tile's rows of both partials (dK times ln2: ds^T q2 =
    // (scale log2e) ds^T q); rows past S belong to no key
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kv = kv0 + r0 + fr + 8 * i;
      if (kv >= S) continue;
      float* pk = dkp + (part + kv) * D + dn + 2 * t;
      float* pv = dvp + (part + kv) * D + dn + 2 * t;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        *reinterpret_cast<float2*>(pk + 8 * jn) =
            make_float2(dk[4 * jn + 2 * i] * LN2, dk[4 * jn + 2 * i + 1] * LN2);
        *reinterpret_cast<float2*>(pv + 8 * jn) =
            make_float2(dv[4 * jn + 2 * i], dv[4 * jn + 2 * i + 1]);
      }
    }
  }
  zero_unseen<D>(dkp, dvp, dq_slot, part, jv * BKV, min(j1 * BKV, S), qb0,
                 min(qb1, q_first(qb0, j0 * BKV, causal)), threadIdx.x, HT);
}


// ===========================================================================
// the split body: CL CTAs of a cluster, each over 128 columns of dh; the
// f32 class (NP 3: six bf16 products of the three-part split) at dh 128 on
// one CTA and dh 256 to 1024 on clusters of dh / 128, the hybrid class (NP
// 1: one product of the casts) at dh 384 to 1024 on clusters of dh / 128
// ===========================================================================
// q2, k, v and do arrive as NP bf16 parts each (t4_split_bwd, or the
// hybrid casts); every product is the products of parts, smallest first
// (prod_a / prod_b of split_bf16.cuh, from P0 on: six for NP 3, hi hi for
// NP 1), each over its whole reduction before the next, into one
// accumulator (the scores) or a fresh one that the CUDA cores add to the
// running sum (the gradients).  The KV tile has 64 rows, all parts of K and
// V stay for the tile; one stage of Q's and dO's parts streams per pair.
// A CTA holds 128 columns of each: all of dh 128 (CL 1), or its 128 of dh
// 128 CL.
template <int CL, int NP = 3>
struct F6 {
  static constexpr int D = 128 * CL;        // the head dim
  static constexpr int BKV = 64;            // KV tile rows
  static constexpr int P0 = NP == 3 ? 0 : 5;   // first of prod_a/prod_b's
  static constexpr int BOX = 64 * 128;      // a [64 d x 64 rows] box, 8 KB
  static constexpr int PART = 2 * BOX;      // a part of a 64-row tile
  static constexpr int TILE = NP * PART;    // the parts, 48 KB (NP 3)
  static constexpr int DS_PART = BKV * 128; // a part of ds^T [64 kv x 64 q]
  static constexpr int ROWS = QT * 4;       // lse (or delta) of a Q tile
  // warpgroup 1's dk and dv [64 x 128] f32 reach warpgroup 0 through K's
  // and V's space, which is at least their size (NP 1: K and V leave room)
  static constexpr int RED = 2 * 64 * 128 * 4;
  static constexpr int KV = 2 * TILE > RED ? 2 * TILE : RED;
  // a cluster's exchange: SLOTS slots of each thread's 32 partial floats
  // of s2 and dp (two in the hybrid class at CL 3 to 8, which has the
  // room: no sender waits); with one slot ds^T's parts live in it once
  // round 2 (CL 2: the pair's message) is read, with two in a place of
  // their own after them
  static constexpr int SLOTS = CL > 2 && NP == 1 ? 2 : 1;
  static constexpr int XCH = CL > 1 ? SLOTS * HT * 32 * 4 : 0;
  static constexpr int DS = CL > 1 && SLOTS == 1 ? XCH : XCH + NP * DS_PART;
  static constexpr int DS_AT = SLOTS == 1 ? 0 : XCH;   // ds^T in the region
  // the exchange's barriers: Xch's full and empty (CL 2), Xrs's receipts
  // (and with one slot its reads)
  static constexpr int XBAR =
      CL == 1 ? 0
              : CL == 2 ? Xch<HT>::NBAR
                        : Xrs<CL < 3 ? 3 : CL, HT, 0, SLOTS>::NBAR;
  // K and V, Q, dO, the slots and ds^T, lse, delta, then kvfull, qfull,
  // ofull and a cluster's exchange barriers
  static constexpr int SMEM = ALIGN + KV + 2 * TILE + DS + 2 * ROWS +
                              (3 + XBAR) * 8;
};
static_assert(F6<1>::SMEM <= SMEM_LIMIT && F6<2>::SMEM <= SMEM_LIMIT,
              "shared memory");
static_assert(F6<2>::SMEM == 230952, "the cluster's budget");
// dh 384 to 1024 (Xrs): the dh-256 route's budget and two barriers more
static_assert(F6<3>::SMEM == 230968 && F6<4>::SMEM == 230968 &&
                  F6<5>::SMEM == 230968 && F6<6>::SMEM == 230968 &&
                  F6<7>::SMEM == 230968 && F6<8>::SMEM == 230968 &&
                  F6<8>::SMEM <= SMEM_LIMIT,
              "the f32 clusters' budget at CL 3 to 8");
// the hybrid class: one part of each tile, K's and V's space kept at the
// 64 KB that warpgroup 1's dk and dv pass through, two slots and ds^T's
// part beside them
static_assert(F6<3, 1>::SMEM == 173608 && F6<4, 1>::SMEM == 173608 &&
                  F6<5, 1>::SMEM == 173608 && F6<6, 1>::SMEM == 173608 &&
                  F6<7, 1>::SMEM == 173608 && F6<8, 1>::SMEM == 173608,
              "the hybrid clusters' budget at CL 3 to 8");
static_assert(F6<2>::XCH >= 3 * F6<2>::DS_PART &&
                  F6<8>::XCH >= 3 * F6<8>::DS_PART,
              "ds^T in the slot");

// one 64-row tile of an operand in its NP parts by TMA (part p's rows
// start p part_rows down the map, the CTA's 128 columns from col on),
// against `bar`, whose bytes the caller expects; one thread
template <int NP>
__device__ __forceinline__ void tma_tiles(uint32_t dst, uint32_t bar,
                                          const CUtensorMap* map,
                                          int part_rows, int row, int col) {
  using P = F6<1, NP>;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      tma_load(dst + p * P::PART + b * P::BOX, map, bar, col + 64 * b,
               p * part_rows + row);
}

// a Q-side tile (Q's or dO's parts) and its rows of `rows_src` (lse or
// delta), against `bar`; one thread
template <int NP>
__device__ __forceinline__ void load_side(uint32_t dst, uint32_t rows_dst,
                                          uint32_t bar,
                                          const CUtensorMap* map,
                                          const float* rows_src,
                                          int part_rows, int row, int col) {
  using P = F6<1, NP>;
  mbar_expect_tx(bar, P::TILE + P::ROWS);
  tma_tiles<NP>(dst, bar, map, part_rows, row, col);
  bulk_load(rows_dst, rows_src + row, P::ROWS, bar);
}

// s (=) A B^T over the CTA's 128 columns, m64n32, the class's products: A
// the 64 rows of a KV-side tile at a (K or V), B 32 rows of a Q-side tile
// at b, both K-major
template <int NP>
__device__ __forceinline__ void score6(float (&s)[16], uint32_t a,
                                       uint32_t b) {
  using P = F6<1, NP>;
#pragma unroll
  for (int p = P::P0; p < 6; ++p)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t col = (kk / 4) * P::BOX + (kk % 4) * 32;
      wgmma_32<0, 0>(s, desc_a(a + prod_a(p) * P::PART + col),
                     desc_a(b + prod_b(p) * P::PART + col),
                     p > P::P0 || kk > 0);
    }
}

// acc [64 kv x 128 d] += F B over 32 queries: F the parts of a [64 x 32] A
// operand in registers, B those 32 rows of a Q-side tile at b, MN-major;
// the class's products into a fresh m64n64 accumulator, 64 columns at a
// time, which the CUDA cores add to acc
template <int NP>
__device__ __forceinline__ void grad6(float (&acc)[64], uint32_t (&f)[NP][8],
                                      uint32_t b) {
  using P = F6<1, NP>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint64_t bd = desc_b(b + h * P::BOX, P::BOX);
    float fresh[32];
    pin(fresh);
    wgmma_fence();
#pragma unroll
    for (int p = P::P0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t* a = f[prod_a(p)] + 4 * kk;
        wgmma_64_rs(fresh, a[0], a[1], a[2], a[3],
                    bd + ((prod_b(p) * P::PART) >> 4) + kk * 128,
                    p > P::P0 || kk > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
    pin(fresh);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[32 * h + x] += fresh[x];
  }
  // the products that read f are done
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(f[p][i])::"memory");
}

// two warpgroups and no producer warp, as fused_sm90_kernel: thread 0
// issues the TMA loads.  The KV tile's 64 rows are wgmma's M in both
// warpgroups; each takes 32 of a Q tile's 64 queries (m64n32 scores) and
// keeps its own dk and dv over them, and warpgroup 1's reach warpgroup 0
// through shared memory once a KV tile, added in one order.  Per pair:
//   dp^T = V dO^T, s2^T = K Q^T     the class's products over the CTA's
//                                   columns (CL > 1: then the cluster's
//                                   partials are summed, sm90_gemm.cuh:
//                                   Xch or Xrs, in cluster_sum's order)
//   p, ds                           in the accumulators, then split into
//                                   NP bf16 A fragments each (NP 1: rounded)
//   dv += p^T dO, dk += ds^T q2     the products over its 32 queries
//   dq += ds K                      each warpgroup 64 of the CTA's dq
//                                   columns over the 64 keys: ds^T's parts
//                                   (written to a swizzled tile by both
//                                   warpgroups) read transposed as A, K
//                                   MN-major
// dO's next tile loads once both warpgroups' dv products have read it,
// during the dk and dq products, Q's once their dk products have, during
// the dq products and the next pair's dp^T; K and V once warpgroup 0 has
// taken warpgroup 1's sums out of their space.  CL > 1: launched in
// clusters of CL CTAs.  With one slot ds^T's parts live in it: a CTA
// writes them once every thread has read the last round (the pair's
// barrier before the ds^T stores), and signals that read (Xch::read,
// Xrs::read, which let its peers send the next pair's first round) only
// once its dq products, the last readers of ds^T, are done.
template <int CL, int NP>
__device__ __forceinline__ void fused6_body(
    unsigned char* smem_raw, const CUtensorMap* mq, const CUtensorMap* mk,
    const CUtensorMap* mv, const CUtensorMap* mo, const float* lse,
    const float* delta, float* dqp, float* dkp, float* dvp, const int* items,
    int S, int BH, int bq, int chunk, int causal, float oscale) {
  using P = F6<CL, NP>;
  constexpr int D = P::D, BKV = P::BKV;
  const uint32_t base = aligned_base(smem_raw);
  float* const fbase =
      reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t sK = base, sV = sK + P::TILE, sQ = sK + P::KV;
  const uint32_t sO = sQ + P::TILE, sX = sO + P::TILE;  // CL > 1: the slots
  const uint32_t sDS = sX + P::DS_AT;                    // ds^T's parts
  const uint32_t sL = sX + P::DS, sE = sL + P::ROWS;
  const uint32_t kvfull = sE + P::ROWS, qfull = kvfull + 8,
                 ofull = qfull + 8;
  const uint32_t xfull = ofull + 8;   // CL > 1: the exchange's barriers
  const float* Lq = fbase + (sL - base) / 4;      // the pair's lse, delta
  const float* Eq = fbase + (sE - base) / 4;

  const Item w = item_of<CL>(items, BH);
  // CL > 1: the CTA's rank in its cluster picks its 128 columns
  const int rank = CL == 1 ? 0 : static_cast<int>(cluster_ctarank());
  const int col0 = 128 * rank;
  const int n_q = S / bq, n_kv = (S + BKV - 1) / BKV;
  const int qb0 = w.qi * bq, qb1 = qb0 + bq;
  const int j0 = w.c * chunk, j1 = min(j0 + chunk, n_kv);
  const int kv_vis = causal ? qb1 : S;
  const int jv = max(j0, min(j1, (kv_vis + BKV - 1) / BKV));
  const int row0 = w.bh * S, part_rows = BH * S;
  // CL > 1: this thread's place in the exchange slot
  [[maybe_unused]] const uint32_t xslot = sX + threadIdx.x * 16;
  // CL > 2 with one slot: the item's pairs (the last one's round-2 reads
  // go unsignalled)
  [[maybe_unused]] int n_pairs = 0;
  if constexpr (CL > 2 && P::SLOTS == 1)
    for (int j = j0; j < jv; ++j) {
      const int q0 = q_first(qb0, j * BKV, causal);
      n_pairs += q0 < qb1 ? (qb1 - q0 + QT - 1) / QT : 0;
    }

  // the loads' cursor (thread 0's): the next pair whose Q side is to load
  Pairs ld{j0, q_first(qb0, j0 * BKV, causal), qb0, qb1, jv, BKV, causal};
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    mbar_init(qfull, 1);
    mbar_init(ofull, 1);
    if constexpr (CL == 2) {
      Xch<HT>{xslot, xfull}.init();
    } else if constexpr (CL > 2) {
      T4_XRS(CL, HT, P::SLOTS, xslot, xfull, xr.init())
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (jv > j0) {
      mbar_expect_tx(kvfull, 2 * P::TILE);
      tma_tiles<NP>(sK, kvfull, mk, part_rows, row0 + j0 * BKV, col0);
      tma_tiles<NP>(sV, kvfull, mv, part_rows, row0 + j0 * BKV, col0);
      load_side<NP>(sO, sE, ofull, mo, delta, part_rows, row0 + ld.q0, col0);
      load_side<NP>(sQ, sL, qfull, mq, lse, part_rows, row0 + ld.q0, col0);
      ld.next();
    }
  }
  __syncthreads();
  // CL > 1: the peers' exchange barriers are set up before any arrival
  if constexpr (CL > 1) cluster_sync();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tid = threadIdx.x % 128;
  const int fr = warp * 16 + g;       // its fragment rows fr and fr + 8
  const int qw = 32 * wg;             // its queries of a Q tile
  const int dc = col0 + 64 * wg;      // its dq columns
  const size_t part = ((size_t)w.bh * n_q + w.qi) * S;   // partial rows
  float* dq_slot = dqp + ((size_t)w.c * BH + w.bh) * S * D;
  // ds^T's parts, and the descriptors of dq's operands (step: 16 keys)
  const uint64_t ds_mn = desc_b(sDS, P::DS_PART);
  const uint64_t k_mn = desc_b(sK + wg * P::BOX, P::BOX);

  float dk[64], dv[64], s[16], dp[16];
  int it = 0;
  for (int j = j0; j < jv; ++j) {
    const int kv0 = j * BKV;
    mbar_wait(kvfull, (j - j0) & 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    for (int q0 = q_first(qb0, kv0, causal); q0 < qb1; q0 += QT, ++it) {
      const uint32_t ph = it & 1;
      if (j > j0) {
        // this pair's dq rows, to be loaded after its other products: into
        // L1 now, while those run
        const float* rowp = dq_slot + (size_t)(q0 + fr) * D + dc;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(
              rowp + (u / 2) * 8 * D + (u % 2) * 32));
      }

      // dp^T and s2^T [64 kv x 32 q] over the CTA's columns
      pin(dp);
      pin(s);
      mbar_wait(ofull, ph);
      wgmma_fence();
      score6<NP>(dp, sV, sO + qw * 128);
      wgmma_commit();
      mbar_wait(qfull, ph);
      score6<NP>(s, sK, sQ + qw * 128);
      wgmma_commit();
      if constexpr (CL > 1) {
        // dp's partial leaves while s2's products run
        wgmma_wait<1>();
        pin(dp);
        if constexpr (CL == 2) {
          xch_send_dp(Xch<HT>{xslot, xfull}, dp, it);
        } else {
          T4_XRS(CL, HT, P::SLOTS, xslot, xfull, xr.send_dp(dp, it))
        }
      }
      wgmma_wait<0>();
      pin(dp);
      pin(s);
      // s2's too, and both summed over the cluster: the same bits in every
      // CTA; the last round's read is signalled after the dq products
      // (ds^T's parts go into the slot)
      if constexpr (CL == 2) {
        xch_sum_scores<false>(Xch<HT>{xslot, xfull}, s, dp, it);
      } else if constexpr (CL > 2) {
        T4_XRS(CL, HT, P::SLOTS, xslot, xfull, xr.sum(s, dp, it))
      }

      // p and ds in place; only a tile that crosses the diagonal masks
      if (causal && kv0 + BKV - 1 > q0 + qw)
        softmax_grad_frag<true>(s, dp, Lq + qw, Eq + qw, kv0 + fr, q0 + qw,
                                S, causal, t);
      else
        softmax_grad_frag<false>(s, dp, Lq + qw, Eq + qw, kv0 + fr,
                                 q0 + qw, S, causal, t);
      uint32_t pf[NP][8], df[NP][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t a[NP], b[NP];
        split_pair<NP>(s[2 * i], s[2 * i + 1], a);
        split_pair<NP>(dp[2 * i], dp[2 * i + 1], b);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          pf[p][i] = a[p];
          df[p][i] = b[p];
        }
      }
      // dv += p^T dO over its 32 queries
      grad6<NP>(dv, pf, sO + qw * 128);
      // both warpgroups are done with this pair's dO and delta: the stage
      // takes the next pair's; and their dq products of the previous pair
      // have read ds^T (CL > 1: and every thread has added the last
      // round's message from the slot): its parts take this pair's, row =
      // key, 64 queries (128 bytes) a row, 16-byte unit u of row r at u ^
      // (r % 8); this warpgroup's queries are units 4 wg .. 4 wg + 3
      named_barrier(1, HT);
      if (threadIdx.x == 0 && !ld.done())
        load_side<NP>(sO, sE, ofull, mo, delta, part_rows, row0 + ld.q0,
                      col0);
      // one slot: generic stores where the peers' st.async wrote
      if constexpr (CL > 1 && P::SLOTS == 1) fence_proxy_async();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = fr + 8 * i;
            const uint32_t at = sDS + p * P::DS_PART + r * 128 +
                                (((4 * wg + jn) ^ (r & 7)) << 4) + 4 * t;
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                         "r"(df[p][2 * jn + i])
                         : "memory");
          }
      fence_proxy_async();

      // dk += ds^T q2 over its 32 queries
      grad6<NP>(dk, df, sQ + qw * 128);
      // ds^T is whole, and both warpgroups are done with this pair's Q and
      // lse: the stage takes the next pair's
      named_barrier(1, HT);
      if (threadIdx.x == 0 && !ld.done()) {
        load_side<NP>(sQ, sL, qfull, mq, lse, part_rows, row0 + ld.q0,
                      col0);
        ld.next();
      }

      // dq rows q0.. of the chunk's slot, its columns dc..: += ds K, the
      // class's products into a fresh accumulator; the chunk's first tile
      // stores, the others load, add and store; the last tile that the Q
      // tile sees in the chunk scales by oscale
      float fq[32];
      pin(fq);
      wgmma_fence();
#pragma unroll
      for (int p = P::P0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_64<1, 1>(fq,
                         ds_mn + ((prod_a(p) * P::DS_PART) >> 4) + kk * 128,
                         k_mn + ((prod_b(p) * P::PART) >> 4) + kk * 128,
                         p > P::P0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(fq);
      // CL > 1: this thread's reads of ds^T are done, so its peers may send
      // the next pair's first round into the slot
      if constexpr (CL == 2) {
        Xch<HT>{xslot, xfull}.read();
      } else if constexpr (CL > 2) {
        T4_XRS(CL, HT, P::SLOTS, xslot, xfull, xr.read(it, n_pairs))
      }
      const int last = causal ? min(jv - 1, (q0 + QT - 1) / BKV) : jv - 1;
      const float scale = j == last ? oscale : 1.f;
      float* rowp = dq_slot + (size_t)(q0 + fr) * D + dc + 2 * t;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* at = rowp + 8 * i * D + 8 * jn;
          float2 v = make_float2(0.f, 0.f);
          if (j > j0) v = *reinterpret_cast<const float2*>(at);
          *reinterpret_cast<float2*>(at) =
              make_float2((v.x + fq[4 * jn + 2 * i]) * scale,
                          (v.y + fq[4 * jn + 2 * i + 1]) * scale);
        }
    }
    // every product of the tile is done: warpgroup 1's dk and dv to
    // warpgroup 0 through K's and V's space, then the next tile's K and V
    named_barrier(1, HT);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        fbase[i * 128 + tid] = dk[i];
        fbase[(64 + i) * 128 + tid] = dv[i];
      }
      fence_proxy_async();
    }
    named_barrier(1, HT);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        dk[i] += fbase[i * 128 + tid];
        dv[i] += fbase[(64 + i) * 128 + tid];
      }
    }
    named_barrier(1, HT);
    if (threadIdx.x == 0 && j + 1 < jv) {
      mbar_expect_tx(kvfull, 2 * P::TILE);
      tma_tiles<NP>(sK, kvfull, mk, part_rows, row0 + (j + 1) * BKV, col0);
      tma_tiles<NP>(sV, kvfull, mv, part_rows, row0 + (j + 1) * BKV, col0);
    }
    // this KV tile's rows of both partials over the CTA's columns (dK
    // times ln2: ds^T q2 = (scale log2e) ds^T q)
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kv = kv0 + fr + 8 * i;
        float* pk = dkp + (part + kv) * D + col0 + 2 * t;
        float* pv = dvp + (part + kv) * D + col0 + 2 * t;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          *reinterpret_cast<float2*>(pk + 8 * jn) = make_float2(
              dk[4 * jn + 2 * i] * LN2, dk[4 * jn + 2 * i + 1] * LN2);
          *reinterpret_cast<float2*>(pv + 8 * jn) =
              make_float2(dv[4 * jn + 2 * i], dv[4 * jn + 2 * i + 1]);
        }
      }
    }
  }
  // CL 2: the pair's last reads of this CTA's messages are its last
  // accesses to its shared memory (a CTA of an item with no pair exchanges
  // nothing, nor does its peer, which shares the item); Xrs leaves none
  // after the loop
  if constexpr (CL == 2) {
    if (it > 0) Xch<HT>{xslot, xfull}.drain(it);
  }
  zero_unseen<D, 128>(dkp, dvp, dq_slot, part, jv * BKV, min(j1 * BKV, S),
                      qb0, min(qb1, q_first(qb0, j0 * BKV, causal)),
                      threadIdx.x, HT, col0);
}

#define T4_FUSED6_PARAMS                                                    \
  const __grid_constant__ CUtensorMap mq,                                   \
      const __grid_constant__ CUtensorMap mk,                               \
      const __grid_constant__ CUtensorMap mv,                               \
      const __grid_constant__ CUtensorMap mo, const float* __restrict__ lse, \
      const float* __restrict__ delta, float* __restrict__ dqp,             \
      float* __restrict__ dkp, float* __restrict__ dvp,                     \
      const int* __restrict__ items, int S, int BH, int bq, int chunk,      \
      int causal, float oscale

// the f32 class on CL CTAs (dh 128 CL): six products
template <int CL>
__global__ void __launch_bounds__(HT, 1)
    fused_f32_sm90_kernel(T4_FUSED6_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  fused6_body<CL, 3>(smem_raw, &mq, &mk, &mv, &mo, lse, delta, dqp, dkp, dvp,
                     items, S, BH, bq, chunk, causal, oscale);
}

// the hybrid class on clusters of CL CTAs (dh 384 to 1024): one product
template <int CL>
__global__ void __launch_bounds__(HT, 1)
    fused_hybrid_sm90_kernel(T4_FUSED6_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  fused6_body<CL, 1>(smem_raw, &mq, &mk, &mv, &mo, lse, delta, dqp, dkp, dvp,
                     items, S, BH, bq, chunk, causal, oscale);
}
#undef T4_FUSED6_PARAMS

// ---- host side -------------------------------------------------------------
struct Fused {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *dqp, *dkp, *dvp;
  const int* items;
  int n_items, bh, s, bq, chunk, causal;
  float oscale;
  cudaStream_t stream;
};

// the four operands' maps: `rows` rows of D columns each, boxes of 64
// columns and QT rows (q, dout) or bkv rows (k, v); false if one cannot be
// made
template <int D>
bool fused_maps(const Fused& a, int rows, int bkv, CUtensorMap* m) {
  const EncodeTiled fn = encode_tiled();
  return fn != nullptr && make_map(&m[0], fn, a.q, rows, D, D, 64, QT) &&
         make_map(&m[1], fn, a.k, rows, D, D, 64, bkv) &&
         make_map(&m[2], fn, a.v, rows, D, D, 64, bkv) &&
         make_map(&m[3], fn, a.dout, rows, D, D, 64, QT);
}

// the kernels read their operands by TMA and lse and delta by bulk copies
bool sm90_args(const Fused& a) {
  return aligned(a.q, 16) && aligned(a.k, 16) && aligned(a.v, 16) &&
         aligned(a.dout, 16) && aligned(a.lse, 16) && aligned(a.delta, 16);
}

template <int D>
int launch_sm90(const Fused& a) {
  CUtensorMap m[4];
  if (!sm90_args(a) || !fused_maps<D>(a, a.bh * a.s, Hy<D>::BKV, m))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(fused_sm90_kernel<D>, dim3(a.n_items * a.bh), HT,
                Hy<D>::SMEM, a.stream, m[0], m[1], m[2], m[3], a.lse,
                a.delta, a.dqp, a.dkp, a.dvp, a.items, a.s, a.bh, a.bq,
                a.chunk, a.causal, a.oscale);
}

// the split body's kernel of (CL, NP)
template <int CL, int NP>
auto fused6_kernel() {
  if constexpr (NP == 3)
    return fused_f32_sm90_kernel<CL>;
  else
    return fused_hybrid_sm90_kernel<CL>;
}

// the operands are NP parts each, [NP, bh, s, dh] bf16: one map over every
// part's rows; an item's CL CTAs launch as a cluster
template <int CL, int NP>
int launch_f6(const Fused& a) {
  using P = F6<CL, NP>;
  CUtensorMap m[4];
  if (!sm90_args(a) || !fused_maps<P::D>(a, NP * a.bh * a.s, P::BKV, m))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(fused6_kernel<CL, NP>(), dim3(CL * a.n_items * a.bh),
                        CL, HT, P::SMEM, a.stream, m[0], m[1], m[2], m[3],
                        a.lse, a.delta, a.dqp, a.dkp, a.dvp, a.items, a.s,
                        a.bh, a.bq, a.chunk, a.causal, a.oscale);
}

// the split body's routes by (dh, parts): F::run<CL, NP>(args) at dh =
// 128 CL, parts = NP (the f32 class at dh 128 to 1024, the hybrid class at
// dh 384 to 1024), else `otherwise`
template <class F, class R, class... A>
R with_f6(int dh, int parts, R otherwise, A... args) {
  if (parts == 3) {
    switch (dh) {
      case 128: return F::template run<1, 3>(args...);
      case 256: return F::template run<2, 3>(args...);
      case 384: return F::template run<3, 3>(args...);
      case 512: return F::template run<4, 3>(args...);
      case 640: return F::template run<5, 3>(args...);
      case 768: return F::template run<6, 3>(args...);
      case 896: return F::template run<7, 3>(args...);
      case 1024: return F::template run<8, 3>(args...);
    }
  } else if (parts == 1) {
    switch (dh) {
      case 384: return F::template run<3, 1>(args...);
      case 512: return F::template run<4, 1>(args...);
      case 640: return F::template run<5, 1>(args...);
      case 768: return F::template run<6, 1>(args...);
      case 896: return F::template run<7, 1>(args...);
      case 1024: return F::template run<8, 1>(args...);
    }
  }
  return otherwise;
}

// the split body's plan: (KV tile rows, shared memory, cluster)
struct RouteF6 {
  template <int CL, int NP>
  static bool run(int* bkv, int* smem, int* cluster) {
    *bkv = F6<CL, NP>::BKV;
    *smem = F6<CL, NP>::SMEM;
    *cluster = CL;
    return true;
  }
};

struct LaunchF6 {
  template <int CL, int NP>
  static int run(const Fused* a) {
    return launch_f6<CL, NP>(*a);
  }
};

struct ClustersF6 {
  template <int CL, int NP>
  static int run(int* n) {
    return max_clusters(fused6_kernel<CL, NP>(), CL, HT, F6<CL, NP>::SMEM,
                        n);
  }
};

// the kernel of (dh, parts) and its plan: KV tile rows (what the plan's
// items are counted in), dynamic shared memory and the CTAs of a cluster;
// false if none (dh 1152 and wider: a cluster of 9+ CTAs is past the 8
// of a portable cluster)
bool route(int dh, int parts, int& bkv, int& smem, int& cluster) {
  cluster = 1;
  if (parts == 1 && (dh == 128 || dh == 256)) {
    bkv = dh == 128 ? Hy<128>::BKV : Hy<256>::BKV;
    smem = dh == 128 ? Hy<128>::SMEM : Hy<256>::SMEM;
    return true;
  }
  return with_f6<RouteF6>(dh, parts, false, &bkv, &smem, &cluster);
}

}  // namespace

// q, k, v, dout: the hybrid class's casts [bh, s, dh] bf16 (parts 1) or
// the f32 class's parts [3, bh, s, dh] bf16 (parts 3: t4_split_bwd of
// flash_bwd.cu), q already times scale*log2e; the f32 class at dh 256 to
// 1024 and the hybrid class at dh 384 to 1024 run on clusters of dh / 128
// CTAs (dh 1152 and wider are refused); lse and delta [bh, s] f32; dqp [s
// / (bkv * chunk) rounded up, bh, s, dh] f32 (one dq partial per KV
// chunk), dkp and dvp [bh, s / bq, s, dh] f32.  items holds n_items pairs
// (Q block, KV chunk) on the device; the grid is n_items * bh * cluster
// CTAs.  (bkv, smem, cluster) name the kernel's plan (route above;
// ops/attn.py:fused_plan): another is refused.  dq = oscale * ds k.
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success).
extern "C" int t4_flash_bwd_fused(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dqp, void* dkp,
                                  void* dvp, const void* items, int n_items,
                                  int bh, int s, int dh, int bq, int bkv,
                                  int chunk, int causal, int parts, int smem,
                                  int cluster, float oscale, void* stream) {
  int want_bkv = 0, want_smem = 0, want_cluster = 0;
  if (bh <= 0 || s <= 0 || bq <= 0 || bq % QT != 0 || s % bq != 0 ||
      n_items <= 0 || chunk <= 0 ||
      !route(dh, parts, want_bkv, want_smem, want_cluster) ||
      bkv != want_bkv || smem != want_smem || cluster != want_cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const Fused a{q, k, v, dout, static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dqp),
                static_cast<float*>(dkp), static_cast<float*>(dvp),
                static_cast<const int*>(items), n_items, bh, s, bq, chunk,
                causal, oscale, static_cast<cudaStream_t>(stream)};
  if (parts == 1 && dh == 128) return launch_sm90<128>(a);
  if (parts == 1 && dh == 256) return launch_sm90<256>(a);
  return with_f6<LaunchF6>(dh, parts,
                           static_cast<int>(cudaErrorInvalidValue), &a);
}

// the most clusters of the fused kernel's route at (dh, parts) that the
// current device runs at once, into *n (an int; a cluster of one CTA off
// the cluster routes): what ops/attn.py:fused_plan sizes its chunk by.
// Returns the query's cudaError_t.
extern "C" int t4_flash_bwd_fused_clusters(int dh, int parts, void* n) {
  int* out = static_cast<int*>(n);
  if (parts == 1 && dh == 128)
    return max_clusters(fused_sm90_kernel<128>, 1, HT, Hy<128>::SMEM, out);
  if (parts == 1 && dh == 256)
    return max_clusters(fused_sm90_kernel<256>, 1, HT, Hy<256>::SMEM, out);
  return with_f6<ClustersF6>(dh, parts,
                             static_cast<int>(cudaErrorInvalidValue), out);
}
