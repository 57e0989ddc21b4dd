// GEMM kernel of the gemm2 / gemm3 / gemm4 words for sm_90a: bf16 products
// on the tensor cores through wgmma, fed by TMA.  It replaces two Pallas TPU
// kernels of tensorforth_tpu/ops/gemm_pallas.py:
//
//   K5a  _mm_kernel, classes default and 3pass: t4_round_bf16 rounds (or
//        splits) the f32 operands to bf16, then t4_gemm_sm90 multiplies
//        with nprod 1 (default) or 3 (3pass)
//   K6   _v8_kernel: t4_gemm_sm90 with nprod 1 on the wrapper's bf16 casts,
//        the scale fused at the flush
//
// What bounds them on this card: operations.  At the words' sizes (1024^3
// and up) a product does hundreds of operations per byte it must move, so
// the tensor cores are the limit, and only wgmma reaches their full rate.
// The kernel in gemm.cu that this one replaces on those paths staged each
// K slab through registers, kept one slab of loads in flight and paid two
// block barriers a slab: about 80% of its time went waiting on memory.
//
// The design: a block owns a BM x BN tile of C and walks K in slabs of 64
// bf16 (one 128-byte row: the width of the 128-byte swizzle).  The slabs
// pass through a ring of ST stages in dynamic shared memory.  Warpgroup 2
// is the producer: one thread issues the TMA loads of a stage (A as one
// [64 k x 128 rows] box, B as BN/64 boxes of [64 n x 64 k]) against the
// stage's `full` barrier, after its `empty` barrier says that the
// consumers are done with it.  Warpgroups 0 and 1 are the consumers: each
// owns 64 rows of the tile and issues wgmma.m64n128k16 with both operands
// read from the swizzled tiles (A K-major, B row-major [K, N], which is
// MN-major: the transpose bit).  A stage goes back to the producer only
// after wgmma.wait_group says that the products reading it are done.
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
// 128 with 3 stages of 64 KB (below).
//
// Class 3pass: a = ah + al with ah = bf16(a), al = bf16(a - f32(ah)), the
// same for b (the rounding pass writes both parts).  Each K slab's three
// products ah bh + ah bl + al bh go into a fresh accumulator, which is then
// added to the running sum on the CUDA cores, whose f32 add rounds to
// nearest (the tensor cores' own accumulation does not, and over thousands
// of K steps that would cost the class its 2e-5).  It needs the second
// accumulator, so its tile is 128 x 128 and its stages hold four tiles.
//
// The machinery (barriers, TMA, descriptors, the raster and the epilogue)
// is in sm90_gemm.cuh, which gemm_sm90_f32.cu (K5b, K7 from f32 operands)
// shares.  Every exported function launches on the given stream,
// allocates nothing, does not synchronize, and returns a cudaError_t as
// int.
#include <algorithm>

#include "sm90_gemm.cuh"

namespace {

constexpr int BM = 128;               // block tile rows: two warpgroups of 64
constexpr int BK = 64;                // K slab: 64 bf16 = one 128-byte row
constexpr int NT = 384;               // consumers: warpgroups 0, 1; producer 2
constexpr int A_TILE = BM * BK * 2;   // bytes of one A box [64 k x 128 rows]
constexpr int B_BOX = 64 * BK * 2;    // bytes of one B box [64 n x 64 k]

__host__ __device__ constexpr int n_parts(int nprod) {
  return nprod == 3 ? 2 : 1;          // hi (and lo) tiles of each operand
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
// (ma, mb).  NPROD 3: ah bh + ah bl + al bh (ma, ma_lo, mb, mb_lo), each
// slab's three into a fresh accumulator added on the CUDA cores.
template <int BN, int NPROD, int ST>
__global__ void __launch_bounds__(NT, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap ma_lo,
                     const __grid_constant__ CUtensorMap mb,
                     const __grid_constant__ CUtensorMap mb_lo,
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
        const uint32_t sa = ring + st * STAGE;
        const uint32_t sb = sa + NP * A_TILE;
        const int k0 = s * BK;
        tma_load(sa, &ma, full, k0, m0);
        if constexpr (NPROD == 3) tma_load(sa + A_TILE, &ma_lo, full, k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load(sb + j * B_BOX, &mb, full, n0 + 64 * j, k0);
          if constexpr (NPROD == 3)
            tma_load(sb + B_TILE + j * B_BOX, &mb_lo, full, n0 + 64 * j, k0);
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
    } else {
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
    }
    store_tile<WN>(acc, C, m0 + wg * 64, n0, m, n, ldc, scale, vec_c);
  }
}

// ---- the rounding pass of K5a ---------------------------------------------
// x [rows, cols] f32, row-major and contiguous -> hi (and lo) [rows, ld]
// bf16 with hi = bf16(x), lo = bf16(x - f32(hi)) (round to nearest even;
// the subtraction flushes subnormals, as the reference's does), zeros in
// columns cols..ld-1.  Bound by bytes: a block covers 1024
// outputs of one row, a thread 8 of them (one 16-byte store a part).
constexpr int RT = 128;         // threads of a rounding block

struct RoundJob {
  const float* x;
  bf16* hi;
  bf16* lo;       // null: round only
  int rows, cols, ld, vec;   // vec: x 16-byte aligned and cols % 4 == 0
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a - b as the TPU (and XLA on the CPU) subtracts in the reference's split:
// subnormal inputs taken as zero, a subnormal result flushed to zero, both
// keeping their sign
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// grid (rows, column blocks, 2): blockIdx.z picks the operand, field by
// field (a reference to either job would copy both to the stack)
__global__ void __launch_bounds__(RT) round_kernel(RoundJob ja, RoundJob jb) {
  const bool second = blockIdx.z != 0;
  const int rows = second ? jb.rows : ja.rows;
  const int ld = second ? jb.ld : ja.ld;
  const int row = blockIdx.x;
  const int c0 = (blockIdx.y * RT + threadIdx.x) * 8;
  if (row >= rows || c0 >= ld) return;
  const int cols = second ? jb.cols : ja.cols;
  const float* src =
      (second ? jb.x : ja.x) + static_cast<size_t>(row) * cols + c0;
  float v[8];
  if ((second ? jb.vec : ja.vec) && c0 + 8 <= cols) {
    const float4 p = *reinterpret_cast<const float4*>(src);
    const float4 q = *reinterpret_cast<const float4*>(src + 4);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c0 + e < cols ? src[e] : 0.f;
  }
  uint4 hi, lo;
  uint32_t* h = &hi.x;
  uint32_t* l = &lo.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    const float2 f = __bfloat1622float2(hh);
    h[e] = pack_bf16(hh);
    l[e] = pack_bf16(__floats2bfloat162_rn(sub_ftz(v[2 * e], f.x),
                                           sub_ftz(v[2 * e + 1], f.y)));
  }
  const size_t off = static_cast<size_t>(row) * ld + c0;
  *reinterpret_cast<uint4*>((second ? jb.hi : ja.hi) + off) = hi;
  bf16* lo_out = second ? jb.lo : ja.lo;
  if (lo_out) *reinterpret_cast<uint4*>(lo_out + off) = lo;
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
                maps[0], maps[1], maps[2], maps[3], c, m, n, k, ldc, scale,
                vec_c);
}

}  // namespace

// C[m,n] (ldc) = scale * (A @ B), or in nprod 3 the 3pass sum, from bf16
// operands laid out as the rounding pass writes them: a = A [m,k] with a
// row pitch of lda (in nprod 3 its hi part, the lo part following at
// a + m lda), b = B [k,n] with ldb (lo at b + k ldb); lda and ldb multiples
// of 8, a and b 16-byte aligned.  (bn, stages, smem) name the tile plan;
// one the library was not built with is refused.
extern "C" int t4_gemm_sm90(const void* a, const void* b, float* c, int m,
                            int n, int k, int lda, int ldb, int ldc,
                            float scale, int nprod, int bn, int stages,
                            int smem, void* stream) {
  const bool split = nprod == 3;
  if (m < 1 || n < 1 || k < 1 || lda % 8 || ldb % 8 || lda < k || ldb < n ||
      !aligned(a, 16) || !aligned(b, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* a_hi = static_cast<const bf16*>(a);
  const bf16* b_hi = static_cast<const bf16*>(b);
  const bf16* a_lo = split ? a_hi + static_cast<size_t>(m) * lda : a_hi;
  const bf16* b_lo = split ? b_hi + static_cast<size_t>(k) * ldb : b_hi;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];
  if (!make_map(&maps[0], fn, a_hi, m, k, lda, BK, BM) ||
      !make_map(&maps[1], fn, a_lo, m, k, lda, BK, BM) ||
      !make_map(&maps[2], fn, b_hi, k, n, ldb, 64, BK) ||
      !make_map(&maps[3], fn, b_lo, k, n, ldb, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nprod == 1 && bn == 256 && stages == 4)
    return launch_gemm<256, 1, 4>(maps, c, m, n, k, ldc, scale, smem, st);
  if (nprod == 3 && bn == 128 && stages == 3)
    return launch_gemm<128, 3, 3>(maps, c, m, n, k, ldc, scale, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5a's rounding pass: a [m,k] -> a_out [parts, m, lda], b [k,n] -> b_out
// [parts, k, ldb] (parts 2 when split: hi, then lo), zero-padded rows
extern "C" int t4_round_bf16(const float* a, const float* b, void* a_out,
                             void* b_out, int m, int n, int k, int lda,
                             int ldb, int split, void* stream) {
  if (m < 1 || n < 1 || k < 1 || lda % 8 || ldb % 8 || lda < k || ldb < n ||
      !aligned(a_out, 16) || !aligned(b_out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_blocks = (std::max(lda, ldb) / 8 + RT - 1) / RT;
  if (col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  bf16* ah = static_cast<bf16*>(a_out);
  bf16* bh = static_cast<bf16*>(b_out);
  bf16* al = split ? ah + static_cast<size_t>(m) * lda : nullptr;
  bf16* bl = split ? bh + static_cast<size_t>(k) * ldb : nullptr;
  const RoundJob ja = {a, ah, al, m, k, lda, k % 4 == 0 && aligned(a, 16)};
  const RoundJob jb = {b, bh, bl, k, n, ldb, n % 4 == 0 && aligned(b, 16)};
  round_kernel<<<dim3(std::max(m, k), col_blocks, 2), RT, 0,
                 static_cast<cudaStream_t>(stream)>>>(ja, jb);
  return static_cast<int>(cudaGetLastError());
}
