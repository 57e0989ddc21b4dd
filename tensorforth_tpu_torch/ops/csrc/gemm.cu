// GEMM kernels of the tensor tier that no word's bf16 path reaches, for
// sm_90a: the first design of the port, with bf16 wmma fragments.  The
// words' bf16 paths (K5a classes default and 3pass, K6) run on the wgmma
// kernel of gemm_sm90.cu.  Here, replacing Pallas TPU kernels of
// tensorforth_tpu/ops/gemm_pallas.py:
//
//   t4_mm_bf16   K5b  _mm_kernel_bf16  f32 in, bf16 multiplicands, f32 out
//   t4_mm_f32    K5a  _mm_kernel, class highest: true f32 FMAs
//   t4_mm_db     K7   _mm_kernel_db    f32 K-slabs streamed through two
//                                      shared-memory stages with cp.async
//
// What bounds them on this card: operations (the tensor cores, the CUDA
// cores for class highest).  What the design does: a block owns a
// 128 x 128 tile of C, walks K in slabs of 32 held in shared memory as
// bf16, and each of its 8 warps multiplies 16 x 16 x 16 bf16 fragments
// (nvcuda::wmma) into f32 accumulators in registers; the next slab's global
// loads are issued before the current slab is multiplied.  That keeps one
// slab of loads in flight, staged through registers, with two block
// barriers a slab: at 4096^3 it runs at 12% of the bf16 peak, waiting on
// memory most of the time (PERF.md).  gemm_sm90.cu is the redesign; K5b and
// K7 move onto it next.  Ragged edges are predicated in the kernel: no
// padded copies (t4_mm_db keeps the zero padding of its TPU counterpart,
// because cp.async needs aligned, in-bounds sources).
// Class highest: f32 FMAs on the CUDA cores, an 8 x 8 register tile per
// thread, as the flash-attention kernels do.
//
// Every exported function launches on the given stream, allocates nothing,
// does not synchronize, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int NT = 256;        // threads: 8 warps as 2 rows x 4 columns
constexpr int BN = 128;        // block tile columns
constexpr int BK = 32;         // K slab
constexpr int LDA_S = BK + 8;  // bf16 per A-tile row (80 B: fragment
                               // pointers stay 32-byte aligned)
constexpr int LDB_S = BN + 8;  // bf16 per B-tile row (272 B)

typedef __nv_bfloat16 bf16;

// ---- guarded loads of 4 consecutive elements ------------------------------
// (row, col) of a rows x cols row-major matrix with leading dimension ld;
// out of range reads as 0.  `vec`: ld % 4 == 0 and the base is aligned to
// one vector, so an in-range group can go as one load.
__device__ __forceinline__ float4 ld4(const float* p, int row, int col,
                                      int rows, int cols, int ld, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows && col < cols) {
    const float* q = p + (size_t)row * ld + col;
    if (vec && col + 3 < cols) {
      v = *reinterpret_cast<const float4*>(q);
    } else {
      v.x = q[0];
      if (col + 1 < cols) v.y = q[1];
      if (col + 2 < cols) v.z = q[2];
      if (col + 3 < cols) v.w = q[3];
    }
  }
  return v;
}

// 4 floats -> 4 bf16 (round to nearest even) at dst (8-byte aligned)
__device__ __forceinline__ void st4_bf16(bf16* dst, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// ---- K5b: the tensor-core body -------------------------------------------
// C[m,n] = A[m,k] @ B[k,n], A and B row-major f32, multiplicands rounded to
// bf16 at the shared-memory store, f32 sums.  Block tile 128 x 128.
constexpr int BM = 128;

__global__ void __launch_bounds__(NT)
    mm_bf16_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int m, int n, int k, int lda,
                   int ldb, int ldc, int vec_a, int vec_b, int vec_c) {
  constexpr int WMF = BM / 32;          // 16-row fragments per warp
  constexpr int NA = BM * BK / 4 / NT;  // 4-element groups per thread, A
  constexpr int NB = BK * BN / 4 / NT;  // and B
  __shared__ __align__(32) bf16 As[BM * LDA_S];
  __shared__ __align__(32) bf16 Bs[BK * LDB_S];
  __shared__ __align__(32) float stage[NT / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / 4, wc = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  FragC acc[WMF][2];
#pragma unroll
  for (int i = 0; i < WMF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  float4 ra[NA], rb[NB];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int idx = tid + i * NT;
    ra[i] = ld4(A, m0 + idx / (BK / 4), (idx % (BK / 4)) * 4, m, k, lda,
                vec_a);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int idx = tid + i * NT;
    rb[i] = ld4(B, idx / (BN / 4), n0 + (idx % (BN / 4)) * 4, k, n, ldb,
                vec_b);
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    // registers -> shared memory, rounding to bf16
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int idx = tid + i * NT;
      st4_bf16(&As[(idx / (BK / 4)) * LDA_S + (idx % (BK / 4)) * 4], ra[i]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = tid + i * NT;
      st4_bf16(&Bs[(idx / (BN / 4)) * LDB_S + (idx % (BN / 4)) * 4], rb[i]);
    }
    __syncthreads();
    // the next slab's loads fly while this one is multiplied
    if (k0 + BK < k) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int idx = tid + i * NT;
        ra[i] = ld4(A, m0 + idx / (BK / 4), k0 + BK + (idx % (BK / 4)) * 4,
                    m, k, lda, vec_a);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int idx = tid + i * NT;
        rb[i] = ld4(B, k0 + BK + idx / (BN / 4),
                    n0 + (idx % (BN / 4)) * 4, k, n, ldb, vec_b);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[WMF];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < WMF; ++i)
        wmma::load_matrix_sync(
            a[i], &As[(wr * WMF * 16 + i * 16) * LDA_S + kk], LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * LDB_S + wc * 32 + j * 16],
                               LDB_S);
#pragma unroll
      for (int i = 0; i < WMF; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the flush: a full, aligned tile goes straight from the fragments; an
  // edge tile goes through the warp's staging square
  const bool direct = vec_c && m0 + BM <= m && n0 + BN <= n;
#pragma unroll
  for (int i = 0; i < WMF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r0 = m0 + wr * WMF * 16 + i * 16;
      const int c0 = n0 + wc * 32 + j * 16;
      if (direct) {
        wmma::store_matrix_sync(C + (size_t)r0 * ldc + c0, acc[i][j], ldc,
                                wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(stage[warp], acc[i][j], 16,
                                wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = r0 + e / 16, c = c0 + e % 16;
          if (r < m && c < n) C[(size_t)r * ldc + c] = stage[warp][e];
        }
        __syncwarp();
      }
    }
}

// ---- K5a, class highest: f32 FMAs on the CUDA cores ------------------------
constexpr int HK = 16;         // K slab
constexpr int HLD = 128 + 4;   // floats per shared-memory row

__global__ void __launch_bounds__(NT)
    mm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int m, int n, int k, int lda,
                  int ldb, int ldc, int vec_a, int vec_b) {
  __shared__ __align__(16) float As[HK * HLD];  // [k][row]: A transposed
  __shared__ __align__(16) float Bs[HK * HLD];  // [k][col]
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  // thread (ty, tx) owns rows 4ty..4ty+3 and 64+4ty.., columns likewise
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += HK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / 4, c = (idx % 4) * 4;
      const float4 v = ld4(A, m0 + row, k0 + c, m, k, lda, vec_a);
      As[(c + 0) * HLD + row] = v.x;
      As[(c + 1) * HLD + row] = v.y;
      As[(c + 2) * HLD + row] = v.z;
      As[(c + 3) * HLD + row] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / 32, c = (idx % 32) * 4;
      *reinterpret_cast<float4*>(&Bs[row * HLD + c]) =
          ld4(B, k0 + row, n0 + c, k, n, ldb, vec_b);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&As[kk * HLD + 4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk * HLD + 64 + 4 * ty]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Bs[kk * HLD + 4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk * HLD + 64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (c < n) C[(size_t)r * ldc + c] = acc[i][j];
    }
  }
}

// ---- K7: f32 K-slabs through two cp.async stages ---------------------------
// A [mp, kp], B [kp, np], C [mp, np], contiguous, every size a multiple of
// the tile (the wrapper pads with zeros), so each 16-byte copy is aligned
// and in bounds.  Slab i+1 is in flight while slab i is rounded to bf16 and
// multiplied.
constexpr int DB_BM = 128;
constexpr int DB_SMEM = 2 * (DB_BM * BK + BK * BN) * 4   // two f32 stages
                        + (DB_BM * LDA_S + BK * LDB_S) * 2;  // bf16 tiles

// one slab = 1024 + 1024 copies of 16 bytes, 4 + 4 per thread, into the
// stage at (Af, Bf); committed as one group
__device__ __forceinline__ void db_copy_slab(float* Af, float* Bf,
                                             const float* A, const float* B,
                                             int slab, int m0, int n0,
                                             int np, int kp) {
  const int tid = threadIdx.x;
  const int k0 = slab * BK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * NT;
    const int row = idx / 8, c = (idx % 8) * 4;
    __pipeline_memcpy_async(Af + row * BK + c,
                            A + (size_t)(m0 + row) * kp + k0 + c, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * NT;
    const int row = idx / 32, c = (idx % 32) * 4;
    __pipeline_memcpy_async(Bf + row * BN + c,
                            B + (size_t)(k0 + row) * np + n0 + c, 16);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(NT)
    mm_db_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int np, int kp) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Af = reinterpret_cast<float*>(smem);  // [2][128 x 32]
  float* Bf = Af + 2 * DB_BM * BK;             // [2][32 x 128]
  bf16* As = reinterpret_cast<bf16*>(Bf + 2 * BK * BN);
  bf16* Bs = As + DB_BM * LDA_S;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 4, wc = warp % 4;
  const int m0 = blockIdx.y * DB_BM, n0 = blockIdx.x * BN;
  const int n_slabs = kp / BK;

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  db_copy_slab(Af, Bf, A, B, 0, m0, n0, np, kp);
  for (int s = 0; s < n_slabs; ++s) {
    const int slot = s % 2;
    if (s + 1 < n_slabs) {
      db_copy_slab(Af + ((s + 1) % 2) * DB_BM * BK,
                   Bf + ((s + 1) % 2) * BK * BN, A, B, s + 1, m0, n0, np, kp);
      __pipeline_wait_prior(1);   // slab s has landed, s+1 may be in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();   // everyone's part of slab s; the bf16 tiles are free
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / 8, c = (idx % 8) * 4;
      st4_bf16(As + row * LDA_S + c,
               *reinterpret_cast<const float4*>(Af + slot * DB_BM * BK +
                                                row * BK + c));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / 32, c = (idx % 32) * 4;
      st4_bf16(Bs + row * LDB_S + c,
               *reinterpret_cast<const float4*>(Bf + slot * BK * BN +
                                                row * BN + c));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[4];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 64 + i * 16) * LDA_S + kk,
                               LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB_S + wc * 32 + j * 16,
                               LDB_S);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          C + (size_t)(m0 + wr * 64 + i * 16) * np + n0 + wc * 32 + j * 16,
          acc[i][j], np, wmma::mem_row_major);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline dim3 grid_for(int m, int n, int bm) {
  return dim3((n + BN - 1) / BN, (m + bm - 1) / bm);
}

}  // namespace

// K5a, class highest
extern "C" int t4_mm_f32(const float* a, const float* b, float* c, int m,
                         int n, int k, int lda, int ldb, int ldc,
                         void* stream) {
  const int va = lda % 4 == 0 && aligned(a, 16);
  const int vb = ldb % 4 == 0 && aligned(b, 16);
  mm_f32_kernel<<<grid_for(m, n, 128), NT, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, c, m, n, k, lda,
                                                       ldb, ldc, va, vb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int t4_mm_bf16(const float* a, const float* b, float* c, int m,
                          int n, int k, int lda, int ldb, int ldc,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int va = lda % 4 == 0 && aligned(a, 16);
  const int vb = ldb % 4 == 0 && aligned(b, 16);
  const int vc = ldc % 4 == 0 && aligned(c, 32);
  mm_bf16_kernel<<<grid_for(m, n, 128), NT, 0, st>>>(a, b, c, m, n, k, lda,
                                                     ldb, ldc, va, vb, vc);
  return static_cast<int>(cudaGetLastError());
}

// mp, np multiples of 128, kp a multiple of 32 (at least 32)
extern "C" int t4_mm_db(const float* a, const float* b, float* c, int mp,
                        int np, int kp, void* stream) {
  if (mp % DB_BM || np % BN || kp % BK || kp < BK || !aligned(a, 16) ||
      !aligned(b, 16) || !aligned(c, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mm_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DB_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  mm_db_kernel<<<dim3(np / BN, mp / DB_BM), NT, DB_SMEM,
                 static_cast<cudaStream_t>(stream)>>>(a, b, c, np, kp);
  return static_cast<int>(cudaGetLastError());
}
