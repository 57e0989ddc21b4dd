// K5a's class highest for sm_90a: true f32 FMAs on the CUDA cores.  It
// replaces the Pallas TPU kernel tensorforth_tpu/ops/gemm_pallas.py
// _mm_kernel (line 94) in that class, where the TPU takes its dot at
// precision HIGHEST:
//
//   t4_mm_f32    K5a  _mm_kernel, class highest: f32 in, f32 FMAs, f32 out
//
// What bounds it on this card: operations, on the CUDA cores (2mnk at the
// 67 TFLOP/s f32 rate: 2.05 ms at 4096^3); the tensor cores have no f32
// product.  What the design does: a block owns a 128 x 128 tile of C and
// walks K in slabs of 16 held in shared memory (A transposed, so a thread
// reads its rows as one vector); each thread keeps an 8 x 8 register tile,
// as the flash-attention kernels do.  Ragged edges are predicated in the
// kernel: no padded copies.  The bf16-product kernels are in gemm_sm90.cu
// (K5a default and 3pass, K6) and gemm_sm90_f32.cu (K5b, K7).
//
// The exported function launches on the given stream, allocates nothing,
// does not synchronize, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads: a 16 x 16 grid of 8 x 8 tiles

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

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline dim3 grid_for(int m, int n) {   // 128 x 128 tiles of C
  return dim3((n + 127) / 128, (m + 127) / 128);
}

}  // namespace

// K5a, class highest
extern "C" int t4_mm_f32(const float* a, const float* b, float* c, int m,
                         int n, int k, int lda, int ldb, int ldc,
                         void* stream) {
  const int va = lda % 4 == 0 && aligned(a, 16);
  const int vb = ldb % 4 == 0 && aligned(b, 16);
  mm_f32_kernel<<<grid_for(m, n), NT, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, c, m, n, k, lda,
                                                       ldb, ldc, va, vb);
  return static_cast<int>(cudaGetLastError());
}
