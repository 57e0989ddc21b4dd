// The phases of the strict-f32 FMA backward kernels (flash_bwd.cu: dK/dV
// and dQ apart at dh 256 in the f32 class; flash_bwd_fused.cu: all three in
// one kernel, its f32 class).  A
// block works on one 64-row query tile against one BK-row key/value tile:
//   phase 1, pds_tiles:  p = exp2(s2 - lse2), ds = p * (dp - delta) as
//            [64, BK] tiles in shared memory, from s2 = Q K^T, dp = dO V^T;
//   phase 2, accum_dkv:  dv += p^T dO, dk += ds^T Q   (KV rows stationary);
//            accum_rows (flash_tile.cuh): dq += ds K  (Q rows stationary).
// Operand tiles have rows of D + 4 floats, the p and ds tiles BK + 4.
#pragma once

#include "flash_tile.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile

// floats of shared memory of a block that holds K, V, Q and dO tiles, the
// ds tile, the p tile too when `with_p`, and the Q tile's lse and delta
constexpr int bwd_smem_floats(int d, int bk, bool with_p) {
  return (2 * bk + 2 * BQ) * (d + 4) + (with_p ? 2 : 1) * BQ * (bk + 4) +
         2 * BQ;
}

// N (2 or 4) consecutive floats, one vector load
template <int N>
__device__ __forceinline__ void loadv(float (&dst)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else {
    static_assert(N == 2, "loadv takes 2 or 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x;
    dst[1] = t.y;
  }
}

// p (in s) and ds (in dp) of rows 4r+i against keys c+16j: s holds the
// base-2 scores and dp holds do v^T on entry
template <int CJ>
__device__ __forceinline__ void softmax_grad(float (&s)[4][CJ],
                                             float (&dp)[4][CJ],
                                             const float* lse2,
                                             const float* delta, int q0,
                                             int k0, bool diag, int r,
                                             int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l2 = lse2[4 * r + i], de = delta[4 * r + i];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      float x = s[i][j];
      if (diag && k0 + c + 16 * j > q0 + 4 * r + i) x = NEG_INF;
      s[i][j] = exp2f(x - l2);
      dp[i][j] = s[i][j] * (dp[i][j] - de);
    }
  }
}

// the Q tile at q0 (times qscale), its dO tile and its rows' base-2 lse
// and delta, into shared memory
template <int D, typename T>
__device__ __forceinline__ void load_q_side(float* Qs, float* Os, float* Ls,
                                            float* Es, const T* q,
                                            const T* dout, const float* lse,
                                            const float* delta, int q0,
                                            float qscale) {
  load_tile<D>(Qs, D + 4, q + (size_t)q0 * D, BQ, qscale);
  load_tile<D>(Os, D + 4, dout + (size_t)q0 * D, BQ, 1.f);
  if (threadIdx.x < BQ) {
    Ls[threadIdx.x] = lse[q0 + threadIdx.x] * LOG2E;
    Es[threadIdx.x] = delta[q0 + threadIdx.x];
  }
}

// phase 1: thread (r, c) computes query rows 4r..4r+3 against key columns
// c+16j and stores ds (and p when WITH_P) into the [BQ, BK] tiles.  `diag`
// says that the tile pair crosses the causal diagonal.
template <int D, int BK, bool WITH_P>
__device__ __forceinline__ void pds_tiles(const float* Qs, const float* Os,
                                          const float* Ks, const float* Vs,
                                          const float* Ls, const float* Es,
                                          float* Ps, float* Ds, int q0,
                                          int k0, bool diag, int r, int c) {
  constexpr int LD = D + 4, LDP = BK + 4, CJ = BK / 16;
  float s[4][CJ], dp[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
  dot_rows<D, CJ>(s, Qs, Ks, LD, r, c);
  dot_rows<D, CJ>(dp, Os, Vs, LD, r, c);
  softmax_grad<CJ>(s, dp, Ls, Es, q0, k0, diag, r, c);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      if constexpr (WITH_P) Ps[(4 * r + i) * LDP + c + 16 * j] = s[i][j];
      Ds[(4 * r + i) * LDP + c + 16 * j] = dp[i][j];
    }
}

// phase 2 of dK/dV: dva += p^T dO, dka += ds^T Q, one query row at a time.
// Thread (r, c) holds kv rows CJ*r..CJ*r+CJ-1 and output columns
// 64jj+4c..+3.
template <int D, int BK>
__device__ __forceinline__ void accum_dkv(float (&dka)[BK / 16][D / 64][4],
                                          float (&dva)[BK / 16][D / 64][4],
                                          const float* Ps, const float* Ds,
                                          const float* Os, const float* Qs,
                                          int r, int c) {
  constexpr int LD = D + 4, LDP = BK + 4, CJ = BK / 16, DJ = D / 64;
#pragma unroll 2
  for (int n = 0; n < BQ; ++n) {
    float pv[CJ], dsv[CJ];
    loadv<CJ>(pv, Ps + n * LDP + CJ * r);
    loadv<CJ>(dsv, Ds + n * LDP + CJ * r);
    float4 ov[DJ], qv[DJ];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      ov[jj] = *reinterpret_cast<const float4*>(Os + n * LD + 64 * jj + 4 * c);
      qv[jj] = *reinterpret_cast<const float4*>(Qs + n * LD + 64 * jj + 4 * c);
    }
#pragma unroll
    for (int i = 0; i < CJ; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dva[i][jj][0] = fmaf(pv[i], ov[jj].x, dva[i][jj][0]);
        dva[i][jj][1] = fmaf(pv[i], ov[jj].y, dva[i][jj][1]);
        dva[i][jj][2] = fmaf(pv[i], ov[jj].z, dva[i][jj][2]);
        dva[i][jj][3] = fmaf(pv[i], ov[jj].w, dva[i][jj][3]);
        dka[i][jj][0] = fmaf(dsv[i], qv[jj].x, dka[i][jj][0]);
        dka[i][jj][1] = fmaf(dsv[i], qv[jj].y, dka[i][jj][1]);
        dka[i][jj][2] = fmaf(dsv[i], qv[jj].z, dka[i][jj][2]);
        dka[i][jj][3] = fmaf(dsv[i], qv[jj].w, dka[i][jj][3]);
      }
  }
}

// the dK and dV rows a thread holds after accum_dkv, to kv rows k0.. of dk
// and dv.  ds^T q2 = (scale*log2e) ds^T q, so ln2 restores scale ds^T q.
template <int D, int BK>
__device__ __forceinline__ void store_dkv(
    const float (&dka)[BK / 16][D / 64][4],
    const float (&dva)[BK / 16][D / 64][4], float* dk, float* dv, int k0,
    int r, int c) {
  constexpr int CJ = BK / 16, DJ = D / 64;
#pragma unroll
  for (int i = 0; i < CJ; ++i) {
    const size_t at = (size_t)(k0 + CJ * r + i) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      *reinterpret_cast<float4*>(dk + at + 64 * jj + 4 * c) =
          make_float4(dka[i][jj][0] * LN2, dka[i][jj][1] * LN2,
                      dka[i][jj][2] * LN2, dka[i][jj][3] * LN2);
      *reinterpret_cast<float4*>(dv + at + 64 * jj + 4 * c) =
          make_float4(dva[i][jj][0], dva[i][jj][1], dva[i][jj][2],
                      dva[i][jj][3]);
    }
  }
}

// the operands of a backward launch, shared by the C entry points
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int bh, s, causal;
  float qscale;
  cudaStream_t stream;
};

}  // namespace
