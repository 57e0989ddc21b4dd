// GEMM kernels of the tensor tier that take f32 operands and round them to
// bf16 inside their one launch, for sm_90a, on wgmma.  They replace two
// Pallas TPU kernels of tensorforth_tpu/ops/gemm_pallas.py, which round in
// their bodies too:
//
//   t4_mm_bf16  K5b  _mm_kernel_bf16 (line 106): f32 in, each block's
//                    operands cast to bf16 in the body, f32 sums, f32 out
//   t4_mm_db    K7   _mm_kernel_db (line 161): f32 K-slabs DMA'd through
//                    two buffers and dotted at default precision (bf16)
//
// Both compute C = bf16(A) @ bf16(B) with f32 sums.  The rounding is to
// nearest even (cvt.rn.bf16x2.f32), as x.to(torch.bfloat16) and
// jnp.astype(bfloat16) round, and keeps subnormals.  K5a class default is
// the same function as a rounding pass and then gemm_sm90.cu's kernel.
//
// What bounds them on this card: operations (2mnk at the 989 TFLOP/s bf16
// rate: 0.139 ms at 4096^3, where the f32 operands' bytes take 0.060).
// What they add to gemm_sm90.cu's kernel is the rounding, and where it
// happens is the design.  Rounding inside the kernel converts each operand
// element once per output tile that reads it (16 times for A, 32 for B at
// 128 x 256 tiles at 4096^3) and reads f32 from L2, twice the bytes of
// bf16, in exchange for the rounding pass's 192 MB round trip through
// device memory.  Both kernels TMA-load f32 slabs of 32 k (128 bytes, the
// swizzle's width: A as one [32 k x 128 rows] box, B as 8 boxes of [32 n x
// 32 k]) and round them in shared memory; the conversion's shared-memory
// traffic (the f32 written by TMA, read back, the bf16 written) is what
// holds them above the bound.  They differ in who rounds B:
//
// K7: the consumers round both, A into registers.  256 threads, two consumer
// warpgroups and no producer warp (thread 0 issues the TMA loads), so a
// thread may hold 255 registers.  A ring of 3 f32 stages.  Each thread
// reads its own A fragment's f32 values and feeds wgmma with A from
// registers (no bf16 copy of A); all 256 round B into an MN-major bf16
// tile in the swizzled layout wgmma's descriptor reads, 3 tiles in turn.
// One block barrier a slab: the tile is written, the f32 stage is read
// (thread 0 refills it at once), and with 3 tiles the products that read
// this tile last are done in both warpgroups (each waits for its previous
// slab's group before it reaches the barrier).  While a slab's products
// run, every thread reads the next slab's f32 values into registers.  The
// A registers of two slabs alternate.  Per 32 k: 144 KB of shared-memory
// traffic, against 48 KB for the same work in gemm_sm90.cu.
//
// K5b: the same f32 stages and bf16 tiles, with the rounding of B in a
// warpgroup of its own.  384 threads: the consumers take A into registers
// as K7's do and run the products; warpgroup 2 rounds each slab's B into
// a tile.  No block barrier: a stage has a `full` barrier (TMA) and an
// `empty` one (every thread's arrival once its A or B is read; consumer
// thread 0 then refills it), a tile a `full` one (the converter's, after
// its proxy fence) and an `empty` one (the consumers', once the products
// that read it are done).  So the conversion of later slabs runs beside
// the products of this one.  setmaxnreg gives the consumers 200
// registers, the converter 104.  (Two other K5b designs were tried on the
// card and dropped, PERF.md section 6: rounding on the way in, from device
// memory through the converter's registers into gemm_sm90.cu's bf16 ring,
// was several times slower than this one, its loads alone as slow; and
// rounding both operands into that ring was slower too.)
//
// TMA zero-fills rows and columns out of bounds, so ragged m, n, k need
// no padded copies; it wants 16-byte row pitches, so both take lda and
// ldb in multiples of 4 f32 (the wrapper pads the rows that are not).  The
// C store is predicated.
//
// Every exported function launches on the given stream, allocates nothing,
// does not synchronize, and returns a cudaError_t as int.
#include "sm90_gemm.cuh"

namespace {

constexpr int BM = 128;        // block tile rows: consumer warpgroups 0, 1
constexpr int BN = 256;        // block tile columns
constexpr int WN = BN / 128;   // m64n128 accumulators a consumer holds
constexpr int NC = 256;        // consumer threads: warpgroups 0, 1

__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d));
}

// ===========================================================================
// what both kernels share: f32 stages of one 32-k slab by TMA, bf16 B tiles
// ===========================================================================
constexpr int SLAB_K = 32;                           // f32 k per slab
constexpr int F_A = BM * SLAB_K * 4;                 // A box [32 k x 128]
constexpr int F_B_BOX = 32 * SLAB_K * 4;             // B box [32 n x 32 k]
constexpr int F_STAGE = F_A + (BN / 32) * F_B_BOX;   // 48 KB
constexpr int T_BOX = 64 * SLAB_K * 2;               // bf16 [64 n x 32 k]
constexpr int T_TILE = (BN / 64) * T_BOX;            // 16 KB

// the f32 slab at k0 (A's box and B's 8) by TMA into stage st of the ring
// at `ring`, against its `full` barrier; one thread issues it
__device__ __forceinline__ void tma_slab(int st, int k0, const CUtensorMap* ma,
                                         const CUtensorMap* mb, uint32_t ring,
                                         uint32_t full0, int m0, int n0) {
  const uint32_t full = full0 + 8 * st;
  const uint32_t sa = ring + st * F_STAGE;
  mbar_expect_tx(full, F_STAGE);
  tma_load(sa, ma, full, k0, m0);
#pragma unroll
  for (int j = 0; j < BN / 32; ++j)
    tma_load(sa + F_A + j * F_B_BOX, mb, full, n0 + 32 * j, k0);
}

// A box: rows of 128 bytes (32 f32 of k), 16-byte unit u of row r at
// u ^ (r % 8).  A consumer thread's A fragment (lane g = lane / 4, t =
// lane % 4; its rows ra and ra + 8, ra % 8 == g): pair i of k step kk is
// row ra + 8 (i & 1), columns 16 kk + 2t + 8 (i >> 1), wgmma's a_i.
__device__ __forceinline__ uint32_t a_pair(uint32_t sa, int ra, int kk, int i,
                                           int g, int t) {
  const int r = ra + 8 * (i & 1), c = 16 * kk + 2 * t + 8 * (i >> 1);
  return sa + r * 128 + (((c >> 2) ^ g) << 4) + ((c & 3) << 2);
}

// B group w (0..31) of a slab: k row 8 (w / 8) + g, n 32 (w % 8) + 8 t, 8
// f32 in units 2t and 2t + 1 of row kr of f32 box w % 8 (src, from the
// stage's B at sb); its 8 bf16 are one unit of the tile's box (w % 8) / 2
// ([64 n x 32 k], MN-major, the 128-byte swizzle) that wgmma's descriptor
// reads (dst).  A warp's 32 lanes touch every bank 4 times a side.
__device__ __forceinline__ uint32_t b_src(uint32_t sb, int w, int g) {
  return sb + (w % 8) * F_B_BOX + (8 * (w / 8) + g) * 128;
}

__device__ __forceinline__ uint32_t b_dst(uint32_t tile, int w, int g, int t) {
  const int j = w % 8;
  return tile + (j / 2) * T_BOX + (8 * (w / 8) + g) * 128 +
         (((4 * (j % 2) + t) ^ g) << 4);
}

// 8 f32 (x, y) rounded into one 16-byte unit of bf16 at dst
__device__ __forceinline__ void round8(uint32_t dst, float4 x, float4 y) {
  sts128(dst, pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
         pack_bf16(y.z, y.w));
}

// ===========================================================================
// K7: the consumers round both operands
// ===========================================================================
constexpr int DB_ST = 3;                             // f32 stages
constexpr int DB_NT = 3;                             // bf16 B tiles
constexpr int DB_SMEM = ALIGN + DB_ST * F_STAGE + DB_NT * T_TILE + DB_ST * 8;
static_assert(DB_SMEM <= SMEM_LIMIT, "shared memory");

// slab s into stage s % DB_ST
__device__ __forceinline__ void db_issue(int s, const CUtensorMap* ma,
                                         const CUtensorMap* mb, uint32_t ring,
                                         uint32_t full0, int m0, int n0) {
  tma_slab(s % DB_ST, s * SLAB_K, ma, mb, ring, full0, m0, n0);
}

// a consumer thread's f32 values of one slab: its A fragment (rows ra and
// ra + 8, columns 16 kk + 2t and 16 kk + 2t + 8, each a pair; entry 4 kk +
// i is wgmma's a_i of k step kk) and its 4 steps of B (8 n each: k row
// 8 (w / 8) + g, n 32 (w % 8) + 8 t for w = warp + 8 i).  g = lane / 4,
// t = lane % 4, ra % 8 == g.
struct DbSlab {
  float2 a[8];
  float4 x[4], y[4];
};

// wait for slab s's stage and read this thread's values from it
__device__ __forceinline__ void db_read(int s, DbSlab& v, uint32_t ring,
                                        uint32_t full0, int ra, int g,
                                        int t) {
  const int st = s % DB_ST;
  mbar_wait(full0 + 8 * st, (s / DB_ST) & 1);
  const uint32_t sa = ring + st * F_STAGE;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v.a[4 * kk + i] = lds64(a_pair(sa, ra, kk, i, g, t));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t src = b_src(sa + F_A, threadIdx.x / 32 + 8 * i, g);
    v.x[i] = lds128(src + (((2 * t) ^ g) << 4));
    v.y[i] = lds128(src + (((2 * t + 1) ^ g) << 4));
  }
}

// the values rounded: A into wgmma's registers, B into bf16 tile `tile`
// (MN-major, [64 n x 32 k] boxes, the 128-byte swizzle)
__device__ __forceinline__ void db_round(const DbSlab& v, uint32_t (&a)[8],
                                         uint32_t tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = pack_bf16(v.a[j].x, v.a[j].y);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    round8(b_dst(tile, threadIdx.x / 32 + 8 * i, g, t), v.x[i], v.y[i]);
}

// one slab s of a consumer thread: its values rounded (A into `a`, B into
// bf16 tile s % DB_NT), the block barrier, then the slab's products.  Past
// the barrier every thread has read stage s % DB_ST, so thread 0 refills
// it with slab s + DB_ST, and every thread reads slab s + 1 into `v` while
// the products run.  `a_prev` holds the previous slab's fragment,
// which its group reads until the wait at the end.
__device__ __forceinline__ void db_slab(int s, int n_slabs, DbSlab& v,
                                        uint32_t (&a)[8],
                                        uint32_t (&a_prev)[8],
                                        float (&acc)[WN][64],
                                        const CUtensorMap* ma,
                                        const CUtensorMap* mb, uint32_t ring,
                                        uint32_t tiles, uint32_t full0,
                                        int m0, int n0, int ra, int g,
                                        int t) {
  const uint32_t tile = tiles + (s % DB_NT) * T_TILE;
  db_round(v, a, tile, g, t);
  fence_proxy_async();
  __syncthreads();      // the bf16 tile is full; the f32 stage is read
  if (threadIdx.x == 0 && s + DB_ST < n_slabs)
    db_issue(s + DB_ST, ma, mb, ring, full0, m0, n0);
#pragma unroll
  for (int h = 0; h < WN; ++h) pin(acc[h]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int h = 0; h < WN; ++h)
      wgmma_128_rs(acc[h], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                   a[4 * kk + 3],
                   desc_b(tile + h * 2 * T_BOX + kk * 16 * 128, T_BOX),
                   1);
  wgmma_commit();
#pragma unroll
  for (int h = 0; h < WN; ++h) pin(acc[h]);
  if (s + 1 < n_slabs) db_read(s + 1, v, ring, full0, ra, g, t);
  wgmma_wait<1>();
  // the previous slab's group is done: only now may its A registers change
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(a_prev[i])::"memory");
}

// two consumer warpgroups and no producer warp (thread 0 issues the TMA
// loads): 8 warps, two on each of the SM's four register files, so that
// ptxas may give a thread up to 255 registers (a ninth warp would cap them
// at 168)
__global__ void __launch_bounds__(NC, 1)
    mm_db_kernel(const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap mb,
                 float* __restrict__ C, int m, int n, int k, int ldc,
                 int vec_c) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = aligned_base(smem_raw);
  const uint32_t tiles = ring + DB_ST * F_STAGE;     // the bf16 B tiles
  const uint32_t full0 = tiles + DB_NT * T_TILE;     // full[DB_ST]
  const int n_slabs = (k + SLAB_K - 1) / SLAB_K;
  int m0, n0;
  tile_origin<BM, BN>(m0, n0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < DB_ST; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < DB_ST && s < n_slabs; ++s)
      db_issue(s, &ma, &mb, ring, full0, m0, n0);
  }
  __syncthreads();

  // warpgroup wg owns rows 64 wg .. 64 wg + 63
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = wg * 64 + (threadIdx.x % 128) / 32 * 16 + g;
  float acc[WN][64];
#pragma unroll
  for (int h = 0; h < WN; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  uint32_t a_even[8] = {}, a_odd[8] = {};
  DbSlab v;
  db_read(0, v, ring, full0, ra, g, t);
  for (int s = 0; s < n_slabs; s += 2) {
    db_slab(s, n_slabs, v, a_even, a_odd, acc, &ma, &mb, ring, tiles, full0,
            m0, n0, ra, g, t);
    if (s + 1 < n_slabs)
      db_slab(s + 1, n_slabs, v, a_odd, a_even, acc, &ma, &mb, ring, tiles,
              full0, m0, n0, ra, g, t);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < WN; ++h) pin(acc[h]);
  store_tile<WN>(acc, C, m0 + wg * 64, n0, m, n, ldc, 1.f, vec_c);
}

// ===========================================================================
// K5b: a converter warpgroup rounds B; the consumers take A as K7's do
// ===========================================================================
constexpr int BF_ST = 3;                             // f32 stages
constexpr int BF_NT = 3;                             // bf16 B tiles
// two barriers a stage and a tile: full and empty
constexpr int BF_SMEM =
    ALIGN + BF_ST * F_STAGE + BF_NT * T_TILE + 2 * (BF_ST + BF_NT) * 8;
static_assert(BF_SMEM <= SMEM_LIMIT, "shared memory");
constexpr int BF_THREADS = NC + 128;   // the consumers and the converter

__global__ void __launch_bounds__(BF_THREADS, 1)
    mm_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   float* __restrict__ C, int m, int n, int k, int ldc,
                   int vec_c) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = aligned_base(smem_raw);
  const uint32_t tiles = ring + BF_ST * F_STAGE;
  const uint32_t full0 = tiles + BF_NT * T_TILE;     // stage full[ST],
  const uint32_t empty0 = full0 + 8 * BF_ST;          // stage empty[ST],
  const uint32_t tfull0 = empty0 + 8 * BF_ST;         // tile full[NT],
  const uint32_t tempty0 = tfull0 + 8 * BF_NT;        // tile empty[NT]
  const int n_slabs = (k + SLAB_K - 1) / SLAB_K;
  int m0, n0;
  tile_origin<BM, BN>(m0, n0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < BF_ST; ++s) {
      mbar_init(full0 + 8 * s, 1);           // expect_tx
      mbar_init(empty0 + 8 * s, NC + 128);   // every thread: A and B read
    }
    for (int s = 0; s < BF_NT; ++s) {
      mbar_init(tfull0 + 8 * s, 128);        // every converter thread
      mbar_init(tempty0 + 8 * s, NC);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < BF_ST && s < n_slabs; ++s)
      tma_slab(s, s * SLAB_K, &ma, &mb, ring, full0, m0, n0);
  }
  __syncthreads();

  if (threadIdx.x >= NC) {
    // ---- converter: B of each slab into bf16 tile s % BF_NT ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;");
    const int tc = threadIdx.x - NC, cw = tc / 32, lane = tc % 32;
    const int g = lane / 4, t = lane % 4;
    for (int s = 0; s < n_slabs; ++s) {
      const int st = s % BF_ST, ti = s % BF_NT;
      if (s >= BF_NT) mbar_wait(tempty0 + 8 * ti, (s / BF_NT - 1) & 1);
      mbar_wait(full0 + 8 * st, (s / BF_ST) & 1);
      const uint32_t sb = ring + st * F_STAGE + F_A;
      const uint32_t tile = tiles + ti * T_TILE;
#pragma unroll
      for (int i = 0; i < 8; ++i) {      // groups w = cw + 4 i
        const uint32_t src = b_src(sb, cw + 4 * i, g);
        round8(b_dst(tile, cw + 4 * i, g, t),
               lds128(src + (((2 * t) ^ g) << 4)),
               lds128(src + (((2 * t + 1) ^ g) << 4)));
      }
      mbar_arrive(empty0 + 8 * st);          // B of the stage is read
      fence_proxy_async();
      mbar_arrive(tfull0 + 8 * ti);          // the tile is full
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;");
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int ra = wg * 64 + (threadIdx.x % 128) / 32 * 16 + g;
    float acc[WN][64];
#pragma unroll
    for (int h = 0; h < WN; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    uint32_t a_even[8] = {}, a_odd[8] = {};
    auto slab = [&](int s, uint32_t (&a)[8], uint32_t (&a_prev)[8]) {
      const int st = s % BF_ST, ti = s % BF_NT;
      mbar_wait(full0 + 8 * st, (s / BF_ST) & 1);
      const uint32_t sa = ring + st * F_STAGE;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = lds64(a_pair(sa, ra, kk, i, g, t));
          a[4 * kk + i] = pack_bf16(v.x, v.y);
        }
      mbar_arrive(empty0 + 8 * st);          // A of the stage is read
      if (threadIdx.x == 0 && s + BF_ST < n_slabs) {
        mbar_wait(empty0 + 8 * st, (s / BF_ST) & 1);
        tma_slab(st, (s + BF_ST) * SLAB_K, &ma, &mb, ring, full0, m0, n0);
      }
      mbar_wait(tfull0 + 8 * ti, (s / BF_NT) & 1);
      const uint32_t tile = tiles + ti * T_TILE;
#pragma unroll
      for (int h = 0; h < WN; ++h) pin(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < WN; ++h)
          wgmma_128_rs(acc[h], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                       a[4 * kk + 3],
                       desc_b(tile + h * 2 * T_BOX + kk * 16 * 128,
                              T_BOX),
                       1);
      wgmma_commit();
#pragma unroll
      for (int h = 0; h < WN; ++h) pin(acc[h]);
      wgmma_wait<1>();
      // the previous slab's products are done: its tile and its A
      // registers are free
#pragma unroll
      for (int i = 0; i < 8; ++i)
        asm volatile("" : "+r"(a_prev[i])::"memory");
      if (s > 0) mbar_arrive(tempty0 + 8 * ((s - 1) % BF_NT));
    };
    for (int s = 0; s < n_slabs; s += 2) {
      slab(s, a_even, a_odd);
      if (s + 1 < n_slabs) slab(s + 1, a_odd, a_even);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < WN; ++h) pin(acc[h]);
    store_tile<WN>(acc, C, m0 + wg * 64, n0, m, n, ldc, 1.f, vec_c);
  }
}

inline dim3 grid_for(int m, int n) {
  return dim3((n + BN - 1) / BN, (m + BM - 1) / BM);
}

}  // namespace

// K5b: C[m,n] (pitch ldc) = bf16(A) @ bf16(B) from f32 A [m,k] (pitch lda)
// and B [k,n] (pitch ldb); lda and ldb multiples of 4, a and b 16-byte
// aligned (TMA's row pitch and base).  smem names the tile plan: the
// kernel refuses another.
extern "C" int t4_mm_bf16(const float* a, const float* b, float* c, int m,
                          int n, int k, int lda, int ldb, int ldc, int smem,
                          void* stream) {
  if (m < 1 || n < 1 || k < 1 || lda < k || ldb < n || ldc < n ||
      lda % 4 || ldb % 4 || !aligned(a, 16) || !aligned(b, 16) ||
      smem != BF_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ma, mb;
  if (!make_map(&ma, fn, a, m, k, lda, SLAB_K, BM, true) ||
      !make_map(&mb, fn, b, k, n, ldb, 32, SLAB_K, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_c = ldc % 2 == 0 && aligned(c, 8);
  return launch(mm_bf16_kernel, grid_for(m, n), BF_THREADS, BF_SMEM,
                static_cast<cudaStream_t>(stream), ma, mb, c, m, n, k, ldc,
                vec_c);
}

// K7: the same product, with the same conditions.
extern "C" int t4_mm_db(const float* a, const float* b, float* c, int m,
                        int n, int k, int lda, int ldb, int ldc, int smem,
                        void* stream) {
  if (m < 1 || n < 1 || k < 1 || lda < k || ldb < n || ldc < n ||
      lda % 4 || ldb % 4 || !aligned(a, 16) || !aligned(b, 16) ||
      smem != DB_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ma, mb;
  if (!make_map(&ma, fn, a, m, k, lda, SLAB_K, BM, true) ||
      !make_map(&mb, fn, b, k, n, ldb, 32, SLAB_K, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_c = ldc % 2 == 0 && aligned(c, 8);
  return launch(mm_db_kernel, grid_for(m, n), NC, DB_SMEM,
                static_cast<cudaStream_t>(stream), ma, mb, c, m, n, k, ldc,
                vec_c);
}
