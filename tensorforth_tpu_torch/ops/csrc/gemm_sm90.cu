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
// Every exported function launches on the given stream, allocates nothing,
// does not synchronize, and returns a cudaError_t as int.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;               // block tile rows: two warpgroups of 64
constexpr int BK = 64;                // K slab: 64 bf16 = one 128-byte row
constexpr int NT = 384;               // consumers: warpgroups 0, 1; producer 2
constexpr int A_TILE = BM * BK * 2;   // bytes of one A box [64 k x 128 rows]
constexpr int B_BOX = 64 * BK * 2;    // bytes of one B box [64 n x 64 k]
constexpr int ALIGN = 1024;           // the 128-byte swizzle repeats every
                                      // 8 rows: tiles start 1024-aligned
constexpr int GROUP_M = 8;            // tile rows per raster group

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`.  A
// wait that outlasts any real one by orders of magnitude traps: a barrier
// that can never complete faults the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 22)) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------
// one box of `map` at (c0 inner, c1 outer) into shared memory at dst; the
// bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// A, K-major: rows of 128 bytes, 8-row groups 1024 bytes apart (the
// leading offset is not used by a swizzled K-major operand)
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// B, MN-major: 64 columns of N per 128-byte row; the next 64 columns are
// the next TMA box (leading offset), the next 8 rows of K 1024 bytes on
// (stride offset)
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return sw128_desc(addr, B_BOX, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (wgmma's results are final only after a wait)
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 sums; B
// transposed (MN-major).  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
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
  const uint32_t ring = (smem_u32(smem_raw) + ALIGN - 1) & ~(ALIGN - 1);
  const uint32_t full0 = ring + ST * STAGE;   // full[ST], then empty[ST]
  const uint32_t empty0 = full0 + 8 * ST;
  const int n_slabs = (k + BK - 1) / BK;

  // grouped raster: GROUP_M tile rows walk the tile columns together
  const int tiles_m = gridDim.y, tiles_n = gridDim.x;
  const int id = blockIdx.y * tiles_n + blockIdx.x;
  const int first = id / (GROUP_M * tiles_n) * GROUP_M;
  const int rows_in_group = min(tiles_m - first, GROUP_M);
  const int local = id % (GROUP_M * tiles_n);
  const int m0 = (first + local % rows_in_group) * BM;
  const int n0 = local / rows_in_group * BN;

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
    const uint32_t a_rows = wg * 64 * 128;   // byte offset in an A tile
    float acc[WN][64];
#pragma unroll
    for (int h = 0; h < WN; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

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
                      desc_b(sb + h * 2 * B_BOX + kk * 16 * 128), 1);
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
          wgmma_128(part, desc_a(ah + 32 * kk), desc_b(bh + kb), kk > 0);
          wgmma_128(part, desc_a(ah + 32 * kk), desc_b(bl + kb), 1);
          wgmma_128(part, desc_a(al + 32 * kk), desc_b(bh + kb), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(part);
        mbar_arrive(empty0 + 8 * st);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += part[i];
      }
    }

    // the flush: scale, then a predicated store.  Fragment layout of
    // m64nNk16: warp w holds rows 16w..16w+15; lane l, rows l/4 and
    // l/4 + 8, columns 2(l%4) and 2(l%4) + 1 of each 8-column block j.
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < WN; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + h * 128 + j * 8 + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 8 * i;
          if (row >= m || col >= n) continue;
          const float v0 = acc[h][4 * j + 2 * i] * scale;
          const float v1 = acc[h][4 * j + 2 * i + 1] * scale;
          float* p = C + static_cast<size_t>(row) * ldc + col;
          if (vec_c && col + 1 < n) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (col + 1 < n) p[1] = v1;
          }
        }
      }
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: taken through the runtime's
// entry-point query, so the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// map of a bf16 [rows, cols] row-major matrix with a row pitch of ld
// elements, in boxes of [box_c x box_r] with the 128-byte swizzle; reads
// outside rows x cols give zeros
bool make_map(CUtensorMap* map, EncodeTiled fn, const void* p, int rows,
              int cols, int ld, int box_c, int box_r) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int BN, int NPROD, int ST>
int launch(const CUtensorMap* maps, float* c, int m, int n, int k, int ldc,
           float scale, int smem, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes(BN, NPROD, ST);
  static_assert(SMEM <= 232448, "shared memory");
  if (smem != SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_sm90_kernel<BN, NPROD, ST>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const int vec_c = ldc % 2 == 0 && aligned(c, 8);
  kernel<<<grid, NT, SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], c, m,
                                     n, k, ldc, scale, vec_c);
  return static_cast<int>(cudaGetLastError());
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
    return launch<256, 1, 4>(maps, c, m, n, k, ldc, scale, smem, st);
  if (nprod == 3 && bn == 128 && stages == 3)
    return launch<128, 3, 3>(maps, c, m, n, k, ldc, scale, smem, st);
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
