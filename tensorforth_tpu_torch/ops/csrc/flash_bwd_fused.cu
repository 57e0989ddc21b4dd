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
// Layout: q, k, v, do [B*h, S, dh] row-major (f32, or bf16 in hybrid
// mode); lse, delta [B*h, S] f32; dq partials [n_slots, B*h, S, dh] f32;
// dkp, dvp [B*h, n_q, S, dh] f32.  S % bq == 0, bq % 64 == 0, dh in {128,
// 256}.
//
// What bounds it on this card, at [16, 2048, 128] causal, bq 1024:
//   hybrid (bf16 multiplicands, f32 sums): the five products are 42.97
//     GFLOP, 0.043 ms at the 989 TFLOP/s of bf16 wgmma; the bytes (bf16
//     operands, the dK/dV partials written and read by the sums, dq, dk,
//     dv) are 218 MB, 0.065 ms at 3.35 TB/s.  The bytes bound it, and the
//     partials are 134 MB of them.
//   f32 (the f32 class, which the split now takes as six bf16 products
//     of a three-part split on the tensor cores, flash_bwd.cu): here still
//     strict-f32 FMAs, operations at the CUDA cores' 67 TFLOP/s, 0.64 ms
//     there and 2.57 ms at [64, 2048, 128].  Three bf16 products (K5a
//     3pass's) cannot hold this class's checks: their products alone,
//     summed exactly, miss the fused-equals-split bound of 1e-5 + 1e-5 |x|
//     by up to 2.8 times (tests/test_torch_attn_fused_sm90.py); six keep
//     it (tests/test_torch_bwd6.py), the route this kernel has yet to take.
//
// The design.  One CTA owns a work item (head, Q block, KV chunk): a run of
// `chunk` KV tiles of one head, against the Q tiles of one Q block that see
// them.  The host plans the items (ops/attn.py:fused_plan): it picks the
// longest chunk that still gives every SM a CTA with work (or one tile),
// whatever bq is, and lists the items heaviest first, since the causal
// load differs from item to item.  Inside a CTA the order is KV tile
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
// f32, fused_f32_kernel: 256 threads, the FMA phases of flash_bwd_tile.cuh
// (BK = 64 at dh 128, 32 at dh 256; 170 KB / 219 KB of shared memory), on
// the same items and slots.

#include "flash_bwd_tile.cuh"
#include "sm90_gemm.cuh"

namespace {

constexpr int QT = 64;       // rows of a Q tile (both kernels)

// one CTA's work item: its head, Q block and KV chunk, from the plan's list
// (items[2 i], items[2 i + 1] = Q block, chunk; every head of item i
// before any of item i + 1)
struct Item {
  int bh, qi, c;
};

__device__ __forceinline__ Item item_of(const int* items, int BH) {
  const int i = static_cast<int>(blockIdx.x / BH);
  return {static_cast<int>(blockIdx.x % BH), items[2 * i], items[2 * i + 1]};
}

// the first Q tile (its first row) of the block at qb0 that sees keys from
// kv0 on: under the causal mask, tile q0 sees key kv0 when kv0 <= q0 + 63
__device__ __forceinline__ int q_first(int qb0, int kv0, int causal) {
  return causal ? max(qb0, kv0 / QT * QT) : qb0;
}

// n floats at p (16-byte aligned, n % 4 == 0) set to zero by `threads`
// threads, this one being `tid`
__device__ __forceinline__ void zero_floats(float* p, size_t n, int tid,
                                            int threads) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = tid; i < n / 4; i += threads)
    reinterpret_cast<float4*>(p)[i] = z;
}

// the rows of an item that no pair writes, set to zero: the rows
// [kz0, kz1) of both partial slabs (keys of the chunk that the Q block
// never sees) and the rows [qb0, qz1) of the chunk's dq slot (Q tiles that
// see no key of the chunk)
template <int D>
__device__ __forceinline__ void zero_unseen(float* dkp, float* dvp,
                                            float* dq_slot, size_t part,
                                            int kz0, int kz1, int qb0,
                                            int qz1, int tid, int threads) {
  if (kz1 > kz0) {
    zero_floats(dkp + (part + kz0) * D, (size_t)(kz1 - kz0) * D, tid,
                threads);
    zero_floats(dvp + (part + kz0) * D, (size_t)(kz1 - kz0) * D, tid,
                threads);
  }
  if (qz1 > qb0)
    zero_floats(dq_slot + (size_t)qb0 * D, (size_t)(qz1 - qb0) * D, tid,
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
// dp^T accumulators of an m64n64 product: element 4 jn + 2 i + c is key
// row kv + 8 i, query column q0 + 8 jn + 2 t + c.  MASK: keys past S, and
// under the causal mask keys after the query, give p = 0.
template <bool MASK>
__device__ __forceinline__ void softmax_grad_frag(float (&s)[32],
                                                  float (&dp)[32],
                                                  const float* Ls,
                                                  const float* Es, int kv,
                                                  int q0, int S, int causal,
                                                  int t) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
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
// f32: the FMA phases of flash_bwd_tile.cuh on the same items
// ===========================================================================
template <int D, int BK>
__global__ void __launch_bounds__(NT, 1)
    fused_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dqp,
                     float* __restrict__ dkp, float* __restrict__ dvp,
                     const int* __restrict__ items, int S, int BH, int bq,
                     int chunk, int causal, float qscale, float oscale) {
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

  const Item w = item_of(items, BH);
  const int n_q = S / bq;
  const int qb0 = w.qi * bq, qb1 = qb0 + bq;
  const int kv_a = w.c * chunk * BK, kv_b = min(kv_a + chunk * BK, S);
  const int kv_vis = min(kv_b, causal ? qb1 : S);  // keys visited: kv_a..
  const size_t head = (size_t)w.bh * S * D;
  const size_t rows = (size_t)w.bh * S;
  const size_t part = ((size_t)w.bh * n_q + w.qi) * S;
  float* dq_slot = dqp + ((size_t)w.c * BH + w.bh) * S * D;
  const int r = threadIdx.x >> 4;  // phase 1: query rows 4r..4r+3;
                                   // dK/dV: kv rows CJ*r..CJ*r+CJ-1;
                                   // dQ: query rows 4r..4r+3
  const int c = threadIdx.x & 15;  // phase 1: key columns c+16j;
                                   // dK/dV, dQ: output columns 64jj+4c..+3

  for (int k0 = kv_a; k0 < kv_vis; k0 += BK) {
    __syncthreads();  // the previous KV tile's K is consumed (dq product)
    load_tile<D>(Ks, LD, k + head + (size_t)k0 * D, BK, 1.f);
    load_tile<D>(Vs, LD, v + head + (size_t)k0 * D, BK, 1.f);

    float dka[CJ][DJ][4], dva[CJ][DJ][4];
#pragma unroll
    for (int i = 0; i < CJ; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
        for (int u = 0; u < 4; ++u) dka[i][jj][u] = dva[i][jj][u] = 0.f;

    for (int q0 = q_first(qb0, k0, causal); q0 < qb1; q0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
      load_q_side<D>(Qs, Os, Ls, Es, q + head, dout + head, lse + rows,
                     delta + rows, q0, qscale);
      __syncthreads();
      pds_tiles<D, BK, true>(Qs, Os, Ks, Vs, Ls, Es, Ps, Ds, q0, k0,
                             causal && k0 + BK - 1 > q0, r, c);
      __syncthreads();
      accum_dkv<D, BK>(dka, dva, Ps, Ds, Os, Qs, r, c);

      // this pair's share of dq, added into the slot's rows: the chunk's
      // first tile stores, the last tile that this Q tile sees in the
      // chunk stores times oscale
      float acc[4][DJ][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.f;
      accum_rows<D, BK>(acc, Ds, LDP, Ks, LD, r, c);  // ds K
      const bool first = k0 == kv_a;
      const float flush =
          k0 == min(kv_b, causal ? q0 + BQ : S) - BK ? oscale : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = dq_slot + (size_t)(q0 + 4 * r + i) * D;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          float4* at = reinterpret_cast<float4*>(row + 64 * jj + 4 * c);
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (!first) x = *at;
          *at = make_float4((x.x + acc[i][jj][0]) * flush,
                            (x.y + acc[i][jj][1]) * flush,
                            (x.z + acc[i][jj][2]) * flush,
                            (x.w + acc[i][jj][3]) * flush);
        }
      }
    }
    store_dkv<D, BK>(dka, dva, dkp + part * D, dvp + part * D, k0, r, c);
  }
  zero_unseen<D>(dkp, dvp, dq_slot, part, max(kv_a, kv_vis), kv_b, qb0,
                 min(qb1, q_first(qb0, kv_a, causal)), threadIdx.x, NT);
}

// ---- host side -------------------------------------------------------------
struct Fused {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *dqp, *dkp, *dvp;
  const int* items;
  int n_items, bh, s, bq, chunk, causal;
  float qscale, oscale;
  cudaStream_t stream;
};

template <int D>
int launch_sm90(const Fused& a) {
  if (a.qscale != 1.f) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) ||
      !aligned(a.dout, 16) || !aligned(a.lse, 16) || !aligned(a.delta, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr int BKV = Hy<D>::BKV;
  const int rows = a.bh * a.s;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, fn, a.q, rows, D, D, 64, QT) ||
      !make_map(&mk, fn, a.k, rows, D, D, 64, BKV) ||
      !make_map(&mv, fn, a.v, rows, D, D, 64, BKV) ||
      !make_map(&mo, fn, a.dout, rows, D, D, 64, QT))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(fused_sm90_kernel<D>, dim3(a.n_items * a.bh), HT,
                Hy<D>::SMEM, a.stream, mq, mk, mv, mo, a.lse, a.delta, a.dqp,
                a.dkp, a.dvp, a.items, a.s, a.bh, a.bq, a.chunk, a.causal,
                a.oscale);
}

template <int D, int BK>
int launch_f32(const Fused& a) {
  constexpr int smem = bwd_smem_floats(D, BK, true) * sizeof(float);
  return launch(fused_f32_kernel<D, BK>, dim3(a.n_items * a.bh), NT, smem,
                a.stream, static_cast<const float*>(a.q),
                static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout), a.lse, a.delta, a.dqp,
                a.dkp, a.dvp, a.items, a.s, a.bh, a.bq, a.chunk, a.causal,
                a.qscale, a.oscale);
}

// the KV tile rows of each kernel: what the plan's items are counted in
int kv_tile(int dh, int bf16) {
  if (bf16) return dh == 128 ? Hy<128>::BKV : Hy<256>::BKV;
  return dh == 128 ? 64 : 32;
}

}  // namespace

// q, k, v, dout [bh, s, dh] (f32, or bf16 when bf16 != 0), lse and delta
// [bh, s] f32, dqp [s / (bkv * chunk) rounded up, bh, s, dh] f32 (one dq
// partial per KV chunk), dkp and dvp [bh, s / bq, s, dh] f32.  items holds
// n_items pairs (Q block, KV chunk) on the device; the grid is n_items * bh
// CTAs.  bkv names the kernel's KV tile (kv_tile above): the kernel refuses
// another.  Q is multiplied by qscale as it is loaded (bf16: qscale must be
// 1, the wrapper scales) and dq = oscale * ds k.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int t4_flash_bwd_fused(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dqp, void* dkp,
                                  void* dvp, const void* items, int n_items,
                                  int bh, int s, int dh, int bq, int bkv,
                                  int chunk, int causal, int bf16,
                                  float qscale, float oscale, void* stream) {
  if (bh <= 0 || s <= 0 || bq <= 0 || bq % QT != 0 || s % bq != 0 ||
      (dh != 128 && dh != 256) || n_items <= 0 || chunk <= 0 ||
      bkv != kv_tile(dh, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Fused a{q, k, v, dout, static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dqp),
                static_cast<float*>(dkp), static_cast<float*>(dvp),
                static_cast<const int*>(items), n_items, bh, s, bq, chunk,
                causal, qscale, oscale, static_cast<cudaStream_t>(stream)};
  if (bf16) return dh == 128 ? launch_sm90<128>(a) : launch_sm90<256>(a);
  return dh == 128 ? launch_f32<128, 64>(a) : launch_f32<256, 32>(a);
}
