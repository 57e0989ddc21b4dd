// Causal/non-causal flash-attention forward for Hopper (sm_90a): its two
// products on the tensor cores through wgmma, fed by TMA.
//
// Replaces tensorforth_tpu/ops/attn_pallas.py:_flash_kernel (line 74;
// launched by flash_attention).  Computes, per (batch*head) and query row,
//   o = softmax(q k^T / sqrt(dh)) v   and   lse = logsumexp(q k^T / sqrt(dh))
// in nats, with an optional causal mask (key position <= query position),
// in the base-2 domain: the wrapper folds scale*log2(e) into q
// (attn_pallas.py:313-316 does the same outside its kernel).  The S x S
// score matrix never reaches device memory.
//
// Layout: q, k, v each [NP, B*h, S, dh] bf16 parts, row-major; o
// [B*h, S, dh] f32; lse [B*h, S] f32.  S % 64 == 0, dh in {128, 256}.
//
// Two classes, one kernel (NP, the parts of each operand):
//   f32 (NP 3): q*scale*log2e, k and v arrive split into three bf16 parts
//     each (t4_split_qkv below: x = hi + mid + lo exactly, split_bf16.cuh),
//     and each product is six bf16 products, smallest first: lo hi, mid
//     mid, hi lo, mid hi, hi mid, hi hi, each over the whole reduction
//     before the next (the tensor cores' adds truncate; the small terms go
//     in while the sum is small).  p is split the same way in registers.
//     Three parts are what holds the class: three products of two parts
//     (K5a 3pass's) reach 0.43-0.82 of the reference's f32 tolerance
//     (2e-5 + 2e-5 |x|) before any rounding of the sums, six 0.002
//     (tests/test_torch_split6.py).
//   hybrid (NP 1): the wrapper's bf16 casts, one product; p rounds to bf16
//     (cvt.rn) before the PV product, as the Pallas kernel's bf16
//     multiplicands do.
//
// What bounds it on this card: operations.  At the serving slice's shape
// ([64, 2048, 128] causal) the two products are 68.75 GFLOP, six times that
// in the f32 class: 0.417 ms at the 989 TFLOP/s of bf16 wgmma, against
// 0.08 ms for its bytes (the f32 class's split parts read once, o and lse
// written once).
//
// The design.  A CTA of two warpgroups owns BQ query rows of one head; K
// and V stream through shared memory in BKV-row tiles (K and V in a ring
// of ST stages each), Q's parts stay for the whole CTA.  Thread 0 issues
// every TMA load (128-byte swizzle): Q's and the first ST tiles' before
// the loop, a K stage again once both warpgroups' score products have read
// it, a V stage once their PV products have.  Per KV tile a warpgroup:
//   s2 = Q K^T      m64nBKV over dh, Q (A) and K (B) K-major from the
//                   swizzled tiles, a fresh accumulator
//   online softmax  the running max, exp2 (ex2.approx: 2 ulp), the row
//                   sums and the rescale of o in f32 on the CUDA cores
//   pv = P V        m64n128 over the BKV keys, P from the s2 accumulator
//                   as bf16 A fragments in registers (split or rounded),
//                   V (B) MN-major: the transpose bit; a fresh accumulator
//                   added to the rescaled o on the CUDA cores, whose adds
//                   round to nearest (the flush K5a does per slab)
// Shared memory in the f32 class, all three parts of each operand:
//   dh 128: BQ 128 (each warpgroup 64 rows, all 128 columns of o), BKV
//     64: Q 96 KB + K 48 KB + V 48 KB = 192 KB, one stage each.  A second
//     stage (96 KB more) does not fit; 64 query rows a CTA would halve the
//     reuse of each K and V tile.  K's next tile loads while this tile's
//     softmax and PV run, V's while the next tile's scores run.
//   dh 256: BQ 64, BKV 32 (each warpgroup all 64 rows and 128 columns of
//     o; both form the scores): Q 96 KB + K 48 KB + V 48 KB.  Registers:
//     o alone is 128 a thread per 64 rows at dh 256, so the columns are
//     split between the warpgroups.
//   hybrid: the same tiles in a third of the bytes, two stages each.
// Registers at dh 128, f32: o 64, the fresh PV accumulator 64, P's three
// parts 48 (the s2 accumulator, 32, dies as they form).
// The grid hands out the longest (last) causal query tiles first; a
// warpgroup skips the products of a KV tile its rows do not see, and only
// a tile that crosses its rows' diagonal tests the mask.

#include "sm90_gemm.cuh"
#include "split_bf16.cuh"

namespace {

constexpr int NT = 256;                  // two warpgroups; thread 0 loads
constexpr float NEG_INF = -1.0e30f;      // attn_pallas.py:25
constexpr float LN2 = 0.6931471805599453f;

template <int D, int NP>
struct Fwd {
  static constexpr int BQ = D == 128 ? 128 : 64;    // query rows of a CTA
  static constexpr int BKV = D == 128 ? 64 : 32;    // rows of a KV tile
  static constexpr int ST = NP == 1 ? 2 : 1;        // stages of K and of V
  static constexpr int NB = D / 64;                 // 128-byte column boxes
  static constexpr int QBOX = BQ * 128;             // a Q box [64 d x BQ]
  static constexpr int KBOX = BKV * 128;            // a K/V box [64 d x BKV]
  static constexpr int Q_PART = NB * QBOX;
  static constexpr int KV_PART = NB * KBOX;
  static constexpr int KV_BYTES = NP * KV_PART;     // a stage of K (or V)
  static constexpr int SMEM =
      ALIGN + NP * Q_PART + 2 * ST * KV_BYTES + (1 + 2 * ST) * 8;
  static constexpr int ROWS_WG = D == 128 ? 64 : 0;   // rows' offset by wg
  static constexpr int COLS_WG = D == 128 ? 0 : 128;  // o columns' offset
  static constexpr int P0 = NP == 3 ? 0 : 5;   // first of prod_a/prod_b's
};
static_assert(Fwd<128, 3>::SMEM <= SMEM_LIMIT &&
                  Fwd<256, 3>::SMEM <= SMEM_LIMIT &&
                  Fwd<128, 1>::SMEM <= SMEM_LIMIT &&
                  Fwd<256, 1>::SMEM <= SMEM_LIMIT,
              "shared memory");

// s2 (+)= A B^T over 16 of dh, m64nBKV, both K-major from shared memory
template <int BKV>
__device__ __forceinline__ void score_mma(float (&d)[BKV / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (BKV == 64)
    wgmma_64<0, 0>(d, da, db, scale_d);
  else
    wgmma_32<0, 0>(d, da, db, scale_d);
}

// one tile of an operand (the map's box of rows, from `row` on) in each
// of its NP parts, by TMA into shared memory at dst (part p at p
// part_bytes, its 64-column boxes box_bytes apart; part p's rows start
// p part_rows down the map), against `bar`; one thread issues them
template <int D, int NP>
__device__ __forceinline__ void load_parts(uint32_t dst, uint32_t bar,
                                           const CUtensorMap* map,
                                           int part_rows, int row,
                                           int part_bytes, int box_bytes) {
  mbar_expect_tx(bar, NP * part_bytes);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      tma_load(dst + p * part_bytes + b * box_bytes, map, bar, 64 * b,
               p * part_rows + row);
}

template <int D, int NP>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     float* __restrict__ o, float* __restrict__ lse, int S,
                     int BH, int causal, float qscale) {
  using P = Fwd<D, NP>;
  constexpr int BQ = P::BQ, BKV = P::BKV, ST = P::ST;
  constexpr int SA = BKV / 2;            // s2 accumulators a thread
  constexpr int NF = BKV / 4;            // P's A-fragment registers a part
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = aligned_base(smem_raw);
  const uint32_t sK = sQ + NP * P::Q_PART;          // K stages, V stages
  const uint32_t sV = sK + ST * P::KV_BYTES;
  const uint32_t qfull = sV + ST * P::KV_BYTES;     // then kfull[ST],
  const uint32_t kfull0 = qfull + 8;                // vfull[ST]
  const uint32_t vfull0 = kfull0 + 8 * ST;

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
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
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_parts<D, NP>(sQ, qfull, &mq, part_rows, row0 + q0, P::Q_PART,
                      P::QBOX);
    for (int s = 0; s < ST && s < n_kv; ++s) {
      load_parts<D, NP>(sK + s * P::KV_BYTES, kfull0 + 8 * s, &mk,
                        part_rows, row0 + s * BKV, P::KV_PART, P::KBOX);
      load_parts<D, NP>(sV + s * P::KV_BYTES, vfull0 + 8 * s, &mv,
                        part_rows, row0 + s * BKV, P::KV_PART, P::KBOX);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qw = q0 + wg * P::ROWS_WG;   // the warpgroup's first query row
  const int dn = wg * P::COLS_WG;        // its columns of o
  const int fr = warp * 16 + g;          // its fragment rows fr and fr + 8
  const bool rows_in = qw < S;           // a Q tile past S has no query
  const uint32_t qa = sQ + wg * P::ROWS_WG * 128;   // A: its rows of Q

  float acc[64], pv[64], s[SA];
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
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
        for (int kk = 0; kk < D / 16; ++kk) {
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
      load_parts<D, NP>(sk, kfull0 + 8 * st, &mk, part_rows,
                        row0 + (j + ST) * BKV, P::KV_PART, P::KBOX);

    // ---- online softmax; element 4 jn + 2 i + c of s is query row
    //      qw + fr + 8 i, key kv0 + 8 jn + 2 t + c
    uint32_t pf[NP][NF];
    if (live) {
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
        l_run[i] = l_run[i] * alpha + rs;   // this thread's share of the sum
        m_run[i] = m_new;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          acc[4 * jn + 2 * i] *= alpha;
          acc[4 * jn + 2 * i + 1] *= alpha;
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
      load_parts<D, NP>(sv, vfull0 + 8 * st, &mv, part_rows,
                        row0 + (j + ST) * BKV, P::KV_PART, P::KBOX);
  }
  if (!rows_in) return;

  // ---- flush: the row sum is spread over the 4 lanes of a row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l_run[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = qw + fr + 8 * i;
    float* orow = o + (static_cast<size_t>(row0) + row) * D + dn + 2 * t;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
      *reinterpret_cast<float2*>(orow + 8 * jn) = make_float2(
          acc[4 * jn + 2 * i] / lt, acc[4 * jn + 2 * i + 1] / lt);
    if (t == 0 && (P::COLS_WG == 0 || wg == 0))
      lse[static_cast<size_t>(row0) + row] = (m_run[i] + log2f(lt)) * LN2;
  }
}

template <int D, int NP>
int launch_fwd(const void* q, const void* k, const void* v, float* o,
               float* lse, int bh, int s, int causal, int bq, int bkv,
               int stages, int smem, float qscale, cudaStream_t stream) {
  using P = Fwd<D, NP>;
  if (bq != P::BQ || bkv != P::BKV || stages != P::ST || smem != P::SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int rows = NP * bh * s;          // every part's rows, one map
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, fn, q, rows, D, D, 64, P::BQ) ||
      !make_map(&mk, fn, k, rows, D, D, 64, P::BKV) ||
      !make_map(&mv, fn, v, rows, D, D, 64, P::BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bh) * ((s + P::BQ - 1) / P::BQ));
  return launch(flash_fwd_kernel<D, NP>, grid, NT, P::SMEM, stream, mq, mk,
                mv, o, lse, s, bh, causal, qscale);
}

}  // namespace

// q, k, v [parts, bh, s, dh] bf16 (parts 3: hi, mid, lo from t4_split_qkv,
// the f32 class; 1: the hybrid class's casts), 16-byte aligned; o [bh, s,
// dh] f32, lse [bh, s] f32.  The scores are qscale (q k^T): the wrappers
// fold the scale into q and pass 1.  (bq, bkv, stages, smem) name the tile
// plan (ops/attn.py:fwd_plan); one the library was not built with is
// refused.  Launches on `stream` and returns the launch's cudaError_t (0 on
// success).
extern "C" int t4_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int s, int dh,
                            int causal, int parts, int bq, int bkv,
                            int stages, int smem, float qscale,
                            void* stream) {
  if (bh <= 0 || s <= 0 || s % 64 != 0 || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define T4_FWD(D, NP)                                                     \
  launch_fwd<D, NP>(q, k, v, of, lf, bh, s, causal, bq, bkv, stages, smem, \
                    qscale, st)
  if (dh == 128 && parts == 3) return T4_FWD(128, 3);
  if (dh == 128 && parts == 1) return T4_FWD(128, 1);
  if (dh == 256 && parts == 3) return T4_FWD(256, 3);
  if (dh == 256 && parts == 1) return T4_FWD(256, 1);
#undef T4_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// the f32 class's operands: q * qscale, k and v [rows, cols] f32 (cols % 8
// == 0, contiguous) -> out [3 (q, k, v), 3 (hi, mid, lo), rows, cols] bf16,
// 16-byte aligned, x = hi + mid + lo (split_bf16.cuh); one launch.
extern "C" int t4_split_qkv(const float* q, const float* k, const float* v,
                            void* out, int rows, int cols, float qscale,
                            void* stream) {
  if (rows < 1 || cols < 8 || cols % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* parts = static_cast<__nv_bfloat16*>(out);
  const size_t op = 3 * static_cast<size_t>(rows) * cols;   // an operand's
  const float* in[3] = {q, k, v};
  SplitJob jobs[3];
  for (int i = 0; i < 3; ++i)
    jobs[i] = {in[i], parts + i * op, rows, cols, cols,
               aligned(in[i], 16) ? 1 : 0, i == 0 ? qscale : 1.f};
  return launch_split(3, jobs, 3, static_cast<cudaStream_t>(stream));
}
