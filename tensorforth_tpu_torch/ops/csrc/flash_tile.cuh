// Shared-memory tile helpers of the strict-f32 FMA flash-attention
// kernel (flash_bwd_tile.cuh's phases: dh 256 in the f32 class of
// flash_bwd_fused.cu): 256-thread blocks laid out as 16 row groups x 16
// column lanes, f32 tiles whose rows are padded by 4 floats.  Its
// constants (NT, LOG2E, LN2) are flash_bwd.cu's too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads: 16 row groups x 16 column lanes
constexpr float NEG_INF = -1.0e30f;     // attn_pallas.py:25
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows x D elements of src (row-major, D per row) -> dst (ld floats per
// row), each value times `scale`
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int rows, float scale) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < rows * V; i += NT) {
    const int row = i / V, col = (i % V) * 4;
    float4 x = load4(src + (size_t)row * D + col);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(dst + row * ld + col) = x;
  }
}

// acc[i][j] += sum over d < D of A[4r+i][d] * B[c+16j][d]: thread (r, c)
// holds a 4 x CJ block of the 64 x 16*CJ product A B^T.  The row strides
// (D + 4 floats) put a warp's two A rows and its sixteen B rows on
// different banks, so the float4 reads are free of conflicts.
template <int D, int CJ>
__device__ __forceinline__ void dot_rows(float (&acc)[4][CJ], const float* A,
                                         const float* B, int ld, int r,
                                         int c) {
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 a[4], b[CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * r + i) * ld + kk);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (c + 16 * j) * ld + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][jj][0..3] += sum over n < BK of P[4r+i][n] * B[n][64jj+4c..+3]:
// thread (r, c) holds a 4 x D/16 block of the 64 x D product P B, P with
// row stride ldp and B with row stride ldb
template <int D, int BK>
__device__ __forceinline__ void accum_rows(float (&acc)[4][D / 64][4],
                                           const float* P, int ldp,
                                           const float* B, int ldb, int r,
                                           int c) {
  constexpr int DJ = D / 64;
#pragma unroll 2
  for (int n = 0; n < BK; n += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(P + (4 * r + i) * ldp + n);
      p[i][0] = t.x;
      p[i][1] = t.y;
      p[i][2] = t.z;
      p[i][3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 b[DJ];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(B + (n + u) * ldb + 64 * jj +
                                                 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          acc[i][jj][0] = fmaf(p[i][u], b[jj].x, acc[i][jj][0]);
          acc[i][jj][1] = fmaf(p[i][u], b[jj].y, acc[i][jj][1]);
          acc[i][jj][2] = fmaf(p[i][u], b[jj].z, acc[i][jj][2]);
          acc[i][jj][3] = fmaf(p[i][u], b[jj].w, acc[i][jj][3]);
        }
    }
  }
}

}  // namespace
