// GEMM kernel of the gemm2 / gemm3 / gemm4 words for sm_90a: bf16 products
// on the tensor cores through wgmma, fed by TMA.  It replaces two Pallas TPU
// kernels of tensorforth_tpu/ops/gemm_pallas.py:
//
//   K5a  _mm_kernel, all three classes: t4_round_bf16 rounds (or splits)
//        the f32 operands to bf16 parts, then t4_gemm_sm90 multiplies with
//        nprod 1 (default), 3 (3pass) or 6 (highest)
//   K6   _v8_kernel: t4_gemm_sm90 with nprod 1 on the wrapper's bf16 casts,
//        the scale fused at the flush
//
// What bounds them on this card: operations.  At the words' sizes (1024^3
// and up) a product does hundreds of operations per byte it must move, so
// the tensor cores are the limit, and only wgmma reaches their full rate.
//
// The design: a block owns a BM x BN tile of C and walks K in slabs of 64
// bf16 (one 128-byte row: the width of the 128-byte swizzle).  The slabs
// pass through a ring of ST stages in dynamic shared memory.  Warpgroup 2
// is the producer: one thread issues the TMA loads of a stage (A as one
// [64 k x 128 rows] box, B as BN/64 boxes of [64 n x 64 k], for each part)
// against the stage's `full` barrier, after its `empty` barrier says that
// the consumers are done with it.  Warpgroups 0 and 1 are the consumers:
// each owns 64 rows of the tile and issues wgmma.m64n128k16 with both
// operands read from the swizzled tiles (A K-major, B row-major [K, N],
// which is MN-major: the transpose bit).  A stage goes back to the producer
// only after wgmma.wait_group says that the products reading it are done.
// setmaxnreg moves registers from the producer to the consumers.  Blocks
// are rastered in groups of GROUP_M tile rows, so that a wave's A and B
// panels stay in the 50 MB L2.  TMA fills out-of-bounds rows and columns
// with zeros, so ragged m, n and k need no padded copies; the store of C is
// predicated.  TMA wants 16-byte row pitches: the operands' rows are
// padded to a multiple of 8 bf16 (the rounding pass writes them so; K6's
// wrapper pads its casts).
//
// Tiles: one product (default, K6) takes 128 x 256, each consumer 64 x 256
// as two m64n128 accumulators, with 4 stages of 48 KB; class 3pass 128 x
// 128 with 3 stages of 64 KB, class highest 128 x 128 with 2 stages of
// 96 KB (below).
//
// Class 3pass: a = ah + al with ah = bf16(a), al = bf16(a - f32(ah)), the
// same for b (the rounding pass writes both parts).  Each K slab's three
// products ah bh + ah bl + al bh go into a fresh accumulator, which is then
// added to the running sum on the CUDA cores, whose f32 add rounds to
// nearest (the tensor cores' own accumulation does not, and over thousands
// of K steps that would cost the class its 2e-5).  It needs the second
// accumulator, so its tile is 128 x 128 and its stages hold four tiles.
//
// Class highest (the TPU's dot at precision HIGHEST, six bf16 products):
// a = ah + am + al exactly (split_bf16.cuh), the same for b, and each K
// slab's six products al bh, am bm, ah bl, am bh, ah bm, ah bh go into a
// fresh accumulator in that order, smallest first and each over the whole
// slab before the next: the tensor cores' adds truncate, so the small
// terms land while the sum is still small, and ah bh's truncation is a few
// units in the last place of the slab's sum.  The slab's sum is added on
// the CUDA cores as in 3pass.  The products left out (am bl, al bm, al bl)
// are below 2^-24 of the terms.  A stage holds three parts of each operand
// (96 KB at 128 x 128), so the ring has two stages.  The bytes each
// block's A and B panels take from L2 are 1.5 times 3pass's for twice its
// products.
//
// The machinery (barriers, TMA, descriptors, the raster and the epilogue)
// is in sm90_gemm.cuh, which gemm_sm90_f32.cu (K5b, K7 from f32 operands)
// and flash_fwd.cu share; the split is in split_bf16.cuh.  Every exported
// function launches on the given stream, allocates nothing, does not
// synchronize, and returns a cudaError_t as int.
#include "sm90_gemm.cuh"
#include "split_bf16.cuh"

namespace {

constexpr int BM = 128;               // block tile rows: two warpgroups of 64
constexpr int BK = 64;                // K slab: 64 bf16 = one 128-byte row
constexpr int NT = 384;               // consumers: warpgroups 0, 1; producer 2
constexpr int A_TILE = BM * BK * 2;   // bytes of one A box [64 k x 128 rows]
constexpr int B_BOX = 64 * BK * 2;    // bytes of one B box [64 n x 64 k]

__host__ __device__ constexpr int n_parts(int nprod) {
  return nprod == 6 ? 3 : nprod == 3 ? 2 : 1;   // bf16 parts of an operand
}

__host__ __device__ constexpr int stage_bytes(int bn, int nprod) {
  return n_parts(nprod) * (A_TILE + (bn / 64) * B_BOX);
}

// the dynamic shared memory a launch needs: the ring, its barriers
// (a full and an empty one per stage) and the slack to align the ring
__host__ __device__ constexpr int smem_bytes(int bn, int nprod, int st) {
  return ALIGN + st * stage_bytes(bn, nprod) + 2 * st * 8;
}

// ---- the product kernel ----------------------------------------------------
// C[m,n] = scale * sum over products of A_p[m,k] @ B_q[k,n].  NPROD 1: A, B
// (ma0, mb0).  NPROD 3: ah bh + ah bl + al bh (parts 0, 1 of each: hi,
// lo).  NPROD 6: the six products of prod_a, prod_b (split_bf16.cuh;
// parts 0, 1, 2: hi, mid, lo).  In both, each slab's products go into a
// fresh accumulator added on the CUDA cores.
template <int BN, int NPROD, int ST>
__global__ void __launch_bounds__(NT, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap ma0,
                     const __grid_constant__ CUtensorMap ma1,
                     const __grid_constant__ CUtensorMap ma2,
                     const __grid_constant__ CUtensorMap mb0,
                     const __grid_constant__ CUtensorMap mb1,
                     const __grid_constant__ CUtensorMap mb2,
                     float* __restrict__ C, int m, int n, int k, int ldc,
                     float scale, int vec_c) {
  static_assert(BN % 128 == 0 && (NPROD == 1 || BN == 128), "tile");
  constexpr int NP = n_parts(NPROD);
  constexpr int STAGE = stage_bytes(BN, NPROD);
  constexpr int B_TILE = (BN / 64) * B_BOX;
  constexpr int WN = BN / 128;        // m64n128 products across the tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = aligned_base(smem_raw);
  const uint32_t full0 = ring + ST * STAGE;   // full[ST], then empty[ST]
  const uint32_t empty0 = full0 + 8 * ST;
  const int n_slabs = (k + BK - 1) / BK;
  int m0, n0;
  tile_origin<BM, BN>(m0, n0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2 * 128);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 2 * 128) {
      for (int s = 0; s < n_slabs; ++s) {
        const int st = s % ST;
        const uint32_t full = full0 + 8 * st;
        if (s >= ST) mbar_wait(empty0 + 8 * st, (s / ST - 1) & 1);
        mbar_expect_tx(full, STAGE);
        const uint32_t sa = ring + st * STAGE;   // A parts, then B parts
        const uint32_t sb = sa + NP * A_TILE;
        const int k0 = s * BK;
        tma_load(sa, &ma0, full, k0, m0);
        if constexpr (NP > 1) tma_load(sa + A_TILE, &ma1, full, k0, m0);
        if constexpr (NP > 2) tma_load(sa + 2 * A_TILE, &ma2, full, k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          const int nj = n0 + 64 * j;
          tma_load(sb + j * B_BOX, &mb0, full, nj, k0);
          if constexpr (NP > 1)
            tma_load(sb + B_TILE + j * B_BOX, &mb1, full, nj, k0);
          if constexpr (NP > 2)
            tma_load(sb + 2 * B_TILE + j * B_BOX, &mb2, full, nj, k0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128;
    float acc[WN][64];
#pragma unroll
    for (int h = 0; h < WN; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    const uint32_t a_rows = wg * 64 * 128;   // byte offset in an A tile
    if constexpr (NPROD == 1) {
      for (int s = 0; s < n_slabs; ++s) {
        const int st = s % ST;
        mbar_wait(full0 + 8 * st, (s / ST) & 1);
        const uint32_t sa = ring + st * STAGE + a_rows;
        const uint32_t sb = ring + st * STAGE + A_TILE;
#pragma unroll
        for (int h = 0; h < WN; ++h) pin(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int h = 0; h < WN; ++h)
            wgmma_128(acc[h], desc_a(sa + 32 * kk),
                      desc_b(sb + h * 2 * B_BOX + kk * 16 * 128, B_BOX), 1);
        wgmma_commit();
#pragma unroll
        for (int h = 0; h < WN; ++h) pin(acc[h]);
        // the previous slab's products are done: its stage goes back
        wgmma_wait<1>();
        if (s > 0) mbar_arrive(empty0 + 8 * ((s - 1) % ST));
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < WN; ++h) pin(acc[h]);
    } else if constexpr (NPROD == 3) {
      float part[64] = {};
      for (int s = 0; s < n_slabs; ++s) {
        const int st = s % ST;
        mbar_wait(full0 + 8 * st, (s / ST) & 1);
        const uint32_t ah = ring + st * STAGE + a_rows;
        const uint32_t al = ah + A_TILE;
        const uint32_t bh = ring + st * STAGE + 2 * A_TILE;
        const uint32_t bl = bh + B_TILE;
        pin(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t kb = kk * 16 * 128;
          wgmma_128(part, desc_a(ah + 32 * kk), desc_b(bh + kb, B_BOX),
                    kk > 0);
          wgmma_128(part, desc_a(ah + 32 * kk), desc_b(bl + kb, B_BOX), 1);
          wgmma_128(part, desc_a(al + 32 * kk), desc_b(bh + kb, B_BOX), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(part);
        mbar_arrive(empty0 + 8 * st);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += part[i];
      }
    } else {
      float part[64] = {};
      for (int s = 0; s < n_slabs; ++s) {
        const int st = s % ST;
        mbar_wait(full0 + 8 * st, (s / ST) & 1);
        const uint32_t sa = ring + st * STAGE + a_rows;
        const uint32_t sb = ring + st * STAGE + NP * A_TILE;
        pin(part);
        wgmma_fence();
        // product by product, each over the whole slab, smallest first
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_128(part, desc_a(sa + prod_a(p) * A_TILE + 32 * kk),
                      desc_b(sb + prod_b(p) * B_TILE + kk * 16 * 128,
                             B_BOX),
                      p > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin(part);
        mbar_arrive(empty0 + 8 * st);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += part[i];
      }
    }
    store_tile<WN>(acc, C, m0 + wg * 64, n0, m, n, ldc, scale, vec_c);
  }
}

// ---- host side -------------------------------------------------------------
template <int BN, int NPROD, int ST>
int launch_gemm(const CUtensorMap* maps, float* c, int m, int n, int k, int ldc,
           float scale, int smem, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes(BN, NPROD, ST);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  if (smem != SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const int vec_c = ldc % 2 == 0 && aligned(c, 8);
  return launch(gemm_sm90_kernel<BN, NPROD, ST>, grid, NT, SMEM, stream,
                maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], c, m, n,
                k, ldc, scale, vec_c);
}

}  // namespace

// C[m,n] (ldc) = scale * (A @ B), or in nprod 3 and 6 the split classes'
// sums, from bf16 operands laid out as the rounding pass writes them: a =
// A [m,k] with a row pitch of lda (in nprod 3 and 6 its hi part, the next
// parts following at a + m lda, a + 2 m lda), b = B [k,n] with ldb (parts at
// b + k ldb, b + 2 k ldb); lda and ldb multiples of 8, a and b 16-byte
// aligned.  (bn, stages, smem) name the tile plan; one the library was not
// built with is refused.
extern "C" int t4_gemm_sm90(const void* a, const void* b, float* c, int m,
                            int n, int k, int lda, int ldb, int ldc,
                            float scale, int nprod, int bn, int stages,
                            int smem, void* stream) {
  if (m < 1 || n < 1 || k < 1 || lda % 8 || ldb % 8 || lda < k || ldb < n ||
      !aligned(a, 16) || !aligned(b, 16) ||
      (nprod != 1 && nprod != 3 && nprod != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = n_parts(nprod);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // maps of A's parts, then B's; a part the class has not reuses the hi part
  CUtensorMap maps[6];
  for (int p = 0; p < 3; ++p) {
    const bf16* ap = static_cast<const bf16*>(a) +
                     static_cast<size_t>(p < np ? p : 0) * m * lda;
    const bf16* bp = static_cast<const bf16*>(b) +
                     static_cast<size_t>(p < np ? p : 0) * k * ldb;
    if (!make_map(&maps[p], fn, ap, m, k, lda, BK, BM) ||
        !make_map(&maps[3 + p], fn, bp, k, n, ldb, 64, BK))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nprod == 1 && bn == 256 && stages == 4)
    return launch_gemm<256, 1, 4>(maps, c, m, n, k, ldc, scale, smem, st);
  if (nprod == 3 && bn == 128 && stages == 3)
    return launch_gemm<128, 3, 3>(maps, c, m, n, k, ldc, scale, smem, st);
  if (nprod == 6 && bn == 128 && stages == 2)
    return launch_gemm<128, 6, 2>(maps, c, m, n, k, ldc, scale, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5a's rounding pass: a [m,k] -> a_out [parts, m, lda], b [k,n] -> b_out
// [parts, k, ldb], zero-padded rows, in one launch of split_bf16.cuh's
// pass.  parts 1: hi; 2: hi, lo (3pass); 3: hi, mid, lo (highest).
extern "C" int t4_round_bf16(const float* a, const float* b, void* a_out,
                             void* b_out, int m, int n, int k, int lda,
                             int ldb, int parts, void* stream) {
  if (m < 1 || n < 1 || k < 1 || lda % 8 || ldb % 8 || lda < k || ldb < n ||
      !aligned(a_out, 16) || !aligned(b_out, 16) || parts < 1 || parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitJob jobs[2] = {
      {a, static_cast<bf16*>(a_out), m, k, lda,
       k % 4 == 0 && aligned(a, 16), 1.f},
      {b, static_cast<bf16*>(b_out), k, n, ldb,
       n % 4 == 0 && aligned(b, 16), 1.f}};
  return launch_split(parts, jobs, 2, static_cast<cudaStream_t>(stream));
}
