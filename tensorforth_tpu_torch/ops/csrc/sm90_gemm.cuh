// The Hopper machinery that gemm_sm90.cu (K5a, K6), gemm_sm90_f32.cu (K5b,
// K7), flash_bwd_fused.cu (K3), flash_fwd.cu (K1) and flash_bwd.cu (K2a,
// K2b) share: mbarriers with a trapping wait, TMA loads (tiles and plain
// bulk copies), wgmma's shared-memory descriptors and its operand forms
// (m64n128, m64n64 and m64n32, A from shared memory or registers, either
// operand transposed), the flash kernels' exp2, the grouped raster of
// output tiles, the predicated epilogue store, and on the host the tensor
// maps.  Everything is in an anonymous namespace: each source that
// includes it is a library of its own.
//
// Tiles are 128 x 256 (or 128 x 128): warpgroups 0 and 1 are consumers
// that own 64 rows each and hold WN m64n128 accumulators.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ALIGN = 1024;           // the 128-byte swizzle repeats every
                                      // 8 rows: tiles start 1024-aligned
constexpr int GROUP_M = 8;            // tile rows per raster group
constexpr int SMEM_LIMIT = 232448;    // a block's dynamic shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first ALIGN-aligned shared address of the dynamic shared memory
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (smem_u32(smem) + ALIGN - 1) & ~(ALIGN - 1);
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

// shared-memory writes of the generic proxy (st.shared) made visible to the
// async proxy (wgmma's operand reads), for the thread that wrote them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// `bytes` (a multiple of 16) of contiguous global memory at src (16-byte
// aligned) into shared memory at dst; the bytes complete a transaction on
// `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the `threads` threads (whole warps) that name barrier `id` (1..15; 0 is
// __syncthreads') wait for each other
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
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

// B, MN-major, in boxes of 64 columns of N (one 128-byte row of bf16) by
// the slab's rows of K: the next 64 columns are the next box, `box` bytes
// on (leading offset), the next 8 rows of K 1024 bytes on (stride offset)
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, uint32_t box) {
  return sw128_desc(addr, box, 1024);
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
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 64 f32 accumulator registers of an m64n128 product, as asm operands
// %0..%63
#define T4_ACC64(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define T4_D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                                 \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                                 \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                                 \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                                 \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// the 32 f32 accumulator registers of an m64n64 product, as asm operands
// %0..%31
#define T4_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define T4_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// the 16 f32 accumulator registers of an m64n32 product, as asm operands
// %0..%15
#define T4_ACC16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define T4_D16                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15}"

// d[64 x 32] (+)= A[64 x 16] B[16 x 32]: wgmma_64's operand forms at N 32
template <int TA, int TB>
__device__ __forceinline__ void wgmma_32(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " T4_D16
      ", %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : T4_ACC16(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 in, f32 sums, both from
// shared memory.  TA 0: A K-major (desc_a); 1: A MN-major, read transposed
// (desc_b's form).  TB likewise for B: 0 K-major (rows of N, desc_a's
// form), 1 MN-major (rows of K, desc_b).  scale_d 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T4_D32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : T4_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 sums; both from
// shared memory, B transposed (MN-major).  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " T4_D64
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : T4_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same product with A from registers: each warp w of the warpgroup
// holds rows 16w..16w+15 as the m16k16 fragment of mma.sync (g = lane / 4,
// t = lane % 4; a0 row g, columns 2t, 2t+1; a1 row g+8; a2 row g, columns
// 2t+8, 2t+9; a3 row g+8, columns 2t+8, 2t+9; the lower column in the low
// half).  The registers are read asynchronously: they must not change
// before a wgmma_wait says that the product is done.
__device__ __forceinline__ void wgmma_128_rs(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " T4_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : T4_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: wgmma_128_rs's forms at N 64 (A
// from registers as there, B MN-major from shared memory)
__device__ __forceinline__ void wgmma_64_rs(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T4_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : T4_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// 2^x (ex2.approx: 2 ulp, subnormal results kept)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to nearest even into one register of two bf16,
// `lo` in the low half (cvt.rn.bf16x2.f32: no flush of subnormals)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- tiles -----------------------------------------------------------------
// this block's output tile origin: GROUP_M tile rows walk the tile columns
// together, so that a wave's A and B panels stay in the 50 MB L2
template <int BM, int BN>
__device__ __forceinline__ void tile_origin(int& m0, int& n0) {
  const int tiles_m = gridDim.y, tiles_n = gridDim.x;
  const int id = blockIdx.y * tiles_n + blockIdx.x;
  const int first = id / (GROUP_M * tiles_n) * GROUP_M;
  const int rows_in_group = min(tiles_m - first, GROUP_M);
  const int local = id % (GROUP_M * tiles_n);
  m0 = (first + local % rows_in_group) * BM;
  n0 = local / rows_in_group * BN;
}

// the flush of one consumer warpgroup's rows row0..row0+63: scale, then a
// predicated store.  Fragment layout of m64nNk16: warp w holds rows
// 16w..16w+15; lane l, rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1
// of each 8-column block j.  vec_c: C 8-byte aligned and ldc even.
template <int WN>
__device__ __forceinline__ void store_tile(float (&acc)[WN][64], float* C,
                                           int row0, int n0, int m, int n,
                                           int ldc, float scale, int vec_c) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = row0 + warp * 16 + lane / 4;
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

// map of a [rows, cols] row-major matrix of bf16 (f32 when `f32`) with a
// row pitch of ld elements, in boxes of [box_c x box_r] with the 128-byte
// swizzle (box_c elements must make 128 bytes); reads outside rows x cols
// give zeros
bool make_map(CUtensorMap* map, EncodeTiled fn, const void* p, int rows,
              int cols, int ld, int box_c, int box_r, bool f32 = false) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(ld) * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(p), dims, pitch, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// set the kernel's dynamic shared memory and launch it on `grid` x
// `threads`; cudaGetLastError() as int
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
