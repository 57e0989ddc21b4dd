// GEMM kernels of the tensor tier (the gemm2 / gemm3 / gemm4 words) for
// sm_90a.  They replace the four Pallas TPU kernels of
// tensorforth_tpu/ops/gemm_pallas.py:
//
//   t4_mm_f32io  _mm_kernel       f32 in, f32 out, K-blocked, class
//                                 default | 3pass | highest
//   t4_mm_bf16   _mm_kernel_bf16  the same product, bf16 rounding explicit
//   t4_mm_v8     _v8_kernel       bf16 in, f32 out, scale fused at the flush
//   t4_mm_db     _mm_kernel_db    f32 K-slabs streamed through two
//                                 shared-memory stages with cp.async
//
// What bounds them on this card: operations.  At the sizes the words run
// (1024^3 and up) a product does hundreds of operations per byte it must
// move, so the tensor cores (the CUDA cores for class highest) are the
// limit and the design keeps operands on chip: a block owns a 128 x 128
// (3pass: 64 x 128) tile of C, walks K in slabs of 32 held in shared memory
// as bf16, and each of its 8 warps multiplies 16 x 16 x 16 bf16 fragments
// (nvcuda::wmma) into f32 accumulators in registers.  The next slab's
// global loads are issued before the current slab is multiplied.  Ragged
// edges are predicated in the kernel: no padded copies (t4_mm_db keeps the
// zero padding of its TPU counterpart, because cp.async needs aligned,
// in-bounds sources).  wgmma, TMA and deeper pipelines are the next step.
//
// Class 3pass: a = ah + al with ah = bf16(a), al = bf16(a - f32(ah)), the
// same for b, split at the shared-memory store; ah bh + ah bl + al bh go
// through the tensor cores into one fragment per K slab, and that fragment
// is added to the running sum on the CUDA cores, whose f32 add rounds to
// nearest (the tensor cores' own accumulation truncates, which over
// thousands of K steps would cost the class its 2e-5).
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

// the bf16 overload keeps the 4 values as loaded (2 x 32 bits): nothing may
// depend on a prefetched value before the slab it belongs to is stored
__device__ __forceinline__ uint2 ld4(const bf16* p, int row, int col,
                                     int rows, int cols, int ld, bool vec) {
  uint2 v = make_uint2(0u, 0u);
  if (row < rows && col < cols) {
    const bf16* q = p + (size_t)row * ld + col;
    if (vec && col + 3 < cols) {
      v = *reinterpret_cast<const uint2*>(q);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(q);
      const uint32_t e0 = s[0];
      const uint32_t e1 = col + 1 < cols ? s[1] : 0;
      const uint32_t e2 = col + 2 < cols ? s[2] : 0;
      const uint32_t e3 = col + 3 < cols ? s[3] : 0;
      v.x = e0 | (e1 << 16);
      v.y = e2 | (e3 << 16);
    }
  }
  return v;
}

template <typename T> struct Raw;
template <> struct Raw<float> { typedef float4 type; };
template <> struct Raw<bf16> { typedef uint2 type; };

__device__ __forceinline__ void st4_bf16(bf16* dst, uint2 v) {
  *reinterpret_cast<uint2*>(dst) = v;
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

// the 3pass split: hi = bf16(v), lo = bf16(v - f32(hi))
__device__ __forceinline__ void st4_split(bf16* hi, bf16* lo, float4 v) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f0 = __bfloat1622float2(h0);
  const float2 f1 = __bfloat1622float2(h1);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&h0);
  raw.y = *reinterpret_cast<const uint32_t*>(&h1);
  *reinterpret_cast<uint2*>(hi) = raw;
  st4_bf16(lo, make_float4(v.x - f0.x, v.y - f0.y, v.z - f1.x, v.w - f1.y));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// ---- the tensor-core body --------------------------------------------------
// C[m,n] = scale * (A[m,k] @ B[k,n]), A and B row-major of type T (f32 or
// bf16), multiplicands rounded to bf16, f32 sums.  WMF: 16-row fragments per
// warp (block tile 32*WMF x 128).  SPLIT: the 3pass class.
template <typename T, int WMF, bool SPLIT>
__device__ __forceinline__ void mm_tc_body(const T* __restrict__ A,
                                           const T* __restrict__ B,
                                           float* __restrict__ C, int m,
                                           int n, int k, int lda, int ldb,
                                           int ldc, float scale, bool vec_a,
                                           bool vec_b, bool vec_c) {
  constexpr int BM = 32 * WMF;
  constexpr int NA = BM * BK / 4 / NT;  // 4-element groups per thread, A
  constexpr int NB = BK * BN / 4 / NT;  // and B
  constexpr int NP = SPLIT ? 2 : 1;     // hi (and lo) tiles
  __shared__ __align__(32) bf16 As[NP][BM * LDA_S];
  __shared__ __align__(32) bf16 Bs[NP][BK * LDB_S];
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

  typename Raw<T>::type ra[NA], rb[NB];
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
    // registers -> shared memory, rounding (or splitting) to bf16
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int idx = tid + i * NT;
      const int off = (idx / (BK / 4)) * LDA_S + (idx % (BK / 4)) * 4;
      if constexpr (SPLIT)
        st4_split(&As[0][off], &As[NP - 1][off], ra[i]);
      else
        st4_bf16(&As[0][off], ra[i]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = tid + i * NT;
      const int off = (idx / (BN / 4)) * LDB_S + (idx % (BN / 4)) * 4;
      if constexpr (SPLIT)
        st4_split(&Bs[0][off], &Bs[NP - 1][off], rb[i]);
      else
        st4_bf16(&Bs[0][off], rb[i]);
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
    if constexpr (SPLIT) {
      FragC part[WMF][2];
#pragma unroll
      for (int i = 0; i < WMF; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA ah[WMF], al[WMF];
        FragB bh[2], bl[2];
#pragma unroll
        for (int i = 0; i < WMF; ++i) {
          const int off = (wr * WMF * 16 + i * 16) * LDA_S + kk;
          wmma::load_matrix_sync(ah[i], &As[0][off], LDA_S);
          wmma::load_matrix_sync(al[i], &As[NP - 1][off], LDA_S);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int off = kk * LDB_S + wc * 32 + j * 16;
          wmma::load_matrix_sync(bh[j], &Bs[0][off], LDB_S);
          wmma::load_matrix_sync(bl[j], &Bs[NP - 1][off], LDB_S);
        }
#pragma unroll
        for (int i = 0; i < WMF; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::mma_sync(part[i][j], ah[i], bh[j], part[i][j]);
            wmma::mma_sync(part[i][j], ah[i], bl[j], part[i][j]);
            wmma::mma_sync(part[i][j], al[i], bh[j], part[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < WMF; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e)
            acc[i][j].x[e] += part[i][j].x[e];
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA a[WMF];
        FragB b[2];
#pragma unroll
        for (int i = 0; i < WMF; ++i)
          wmma::load_matrix_sync(
              a[i], &As[0][(wr * WMF * 16 + i * 16) * LDA_S + kk], LDA_S);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              b[j], &Bs[0][kk * LDB_S + wc * 32 + j * 16], LDB_S);
#pragma unroll
        for (int i = 0; i < WMF; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // the flush: scale, then store.  A full, aligned tile goes straight from
  // the fragments; an edge tile goes through the warp's staging square.
  const bool direct = vec_c && m0 + BM <= m && n0 + BN <= n;
#pragma unroll
  for (int i = 0; i < WMF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r0 = m0 + wr * WMF * 16 + i * 16;
      const int c0 = n0 + wc * 32 + j * 16;
#pragma unroll
      for (int e = 0; e < acc[i][j].num_elements; ++e)
        acc[i][j].x[e] *= scale;
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

// K5a, classes default and 3pass
template <int WMF, bool SPLIT>
__global__ void __launch_bounds__(NT)
    mm_f32io_kernel(const float* A, const float* B, float* C, int m, int n,
                    int k, int lda, int ldb, int ldc, int vec_a, int vec_b,
                    int vec_c) {
  mm_tc_body<float, WMF, SPLIT>(A, B, C, m, n, k, lda, ldb, ldc, 1.0f, vec_a,
                                vec_b, vec_c);
}

// K5b: the bf16 rounding of both tiles is the body's own shared-memory store
__global__ void __launch_bounds__(NT)
    mm_bf16_kernel(const float* A, const float* B, float* C, int m, int n,
                   int k, int lda, int ldb, int ldc, int vec_a, int vec_b,
                   int vec_c) {
  mm_tc_body<float, 4, false>(A, B, C, m, n, k, lda, ldb, ldc, 1.0f, vec_a,
                              vec_b, vec_c);
}

// K6: bf16 operands, the scale fused at the flush
__global__ void __launch_bounds__(NT)
    mm_v8_kernel(const bf16* A, const bf16* B, float* C, int m, int n, int k,
                 int lda, int ldb, int ldc, float scale, int vec_a, int vec_b,
                 int vec_c) {
  mm_tc_body<bf16, 4, false>(A, B, C, m, n, k, lda, ldb, ldc, scale, vec_a,
                             vec_b, vec_c);
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

// prec: 0 default, 1 3pass, 2 highest
extern "C" int t4_mm_f32io(const float* a, const float* b, float* c, int m,
                           int n, int k, int lda, int ldb, int ldc, int prec,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int va = lda % 4 == 0 && aligned(a, 16);
  const int vb = ldb % 4 == 0 && aligned(b, 16);
  const int vc = ldc % 4 == 0 && aligned(c, 32);
  if (prec == 0)
    mm_f32io_kernel<4, false><<<grid_for(m, n, 128), NT, 0, st>>>(
        a, b, c, m, n, k, lda, ldb, ldc, va, vb, vc);
  else if (prec == 1)
    mm_f32io_kernel<2, true><<<grid_for(m, n, 64), NT, 0, st>>>(
        a, b, c, m, n, k, lda, ldb, ldc, va, vb, vc);
  else if (prec == 2)
    mm_f32_kernel<<<grid_for(m, n, 128), NT, 0, st>>>(a, b, c, m, n, k, lda,
                                                      ldb, ldc, va, vb);
  else
    return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" int t4_mm_v8(const void* a, const void* b, float* c, int m, int n,
                        int k, int lda, int ldb, int ldc, float scale,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int va = lda % 4 == 0 && aligned(a, 8);
  const int vb = ldb % 4 == 0 && aligned(b, 8);
  const int vc = ldc % 4 == 0 && aligned(c, 32);
  mm_v8_kernel<<<grid_for(m, n, 128), NT, 0, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), c, m, n, k,
      lda, ldb, ldc, scale, va, vb, vc);
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
