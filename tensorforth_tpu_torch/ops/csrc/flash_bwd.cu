// Flash-attention backward for Hopper (sm_90a): two kernels, dK/dV and dQ.
//
// Replaces tensorforth_tpu/ops/attn_pallas.py:_flash_bwd_dkv_kernel and
// :_flash_bwd_dq_kernel (both launched by flash_attention_bwd).  Given
// q, k, v, the forward's log-sum-exp `lse` (nats), the output cotangent
// `do` and delta = sum_d do*o - dlse, they compute per (batch*head)
//   s2 = (q*scale*log2e) k^T, causal mask,   p = exp2(s2 - lse*log2e)
//   dp = do v^T,                             ds = p * (dp - delta)
//   dv = p^T do,   dk = ln2 * ds^T (q*scale*log2e),   dq = scale * ds k
// with the S x S tiles p and ds kept on chip.  scale*log2e is folded into
// Q and log2e into lse as they are loaded, so the probability tile costs
// one exp2 per score; delta is computed outside (one row reduction).
//
// Layout: q, k, v, do [B*h, S, dh] row-major (f32, or bf16 in hybrid
// mode); lse, delta [B*h, S] f32; dq, dk, dv [B*h, S, dh] f32.
// S % 64 == 0, dh in {128, 256}.
//
// What bounds them on this card: operations.  At the training slice's
// shape (B*h=64, S=2048, dh=128, causal) dK/dV does 4 products = 137.5
// GFLOP and dQ 3 products = 103.1 GFLOP, against about 400 MB and 340 MB
// of traffic; the products are strict-f32 FMAs on the CUDA cores (67
// TFLOP/s peak), as the forward's are.  The design is the forward's:
//   * 256-thread blocks, 64-row query tiles; a thread holds a 4 x (BK/16)
//     block of the score tile and a (rows) x dh/16 block of each output
//     accumulator in registers, and all multiplicands are read as float4
//     from shared-memory tiles whose rows are padded by 4 floats;
//   * tiles: BK = 64 key/value rows at dh=128 (four operand tiles of
//     64 x 132 floats plus p and ds: 170 KB, one block per SM) and BK = 32
//     at dh=256 (219 KB), which also halves the two dK/dV accumulators to
//     64 registers so that nothing spills;
//   * the sequential grid dimension of the TPU kernels is a loop inside
//     the block: a dK/dV block owns one KV tile and loops over the Q tiles
//     that see it, a dQ block owns one Q tile and loops over its KV tiles.
//     EVERY OUTPUT ELEMENT HAS EXACTLY ONE WRITER: there are no atomics
//     and no partial sums across blocks, so the gradients are the same
//     from run to run;
//   * under the causal mask a tile that lies wholly in the future is never
//     visited.  Masked entries of a visited tile give exp2(-1e30 - lse2),
//     which is exactly 0.  The load mirrors the forward's: KV tile 0 (dK/dV)
//     and the last Q tile (dQ) are the longest and are handed out first.
// wgmma, TMA and overlapping the loads with the products are later work.
//
// Hybrid mode: q (already scaled), k, v, do arrive as bf16, and p and ds
// are rounded to bf16 before their products, as the Pallas kernels' bf16
// multiplicands are; ds itself is formed from the unrounded p.  Products
// and sums stay f32.

#include "flash_tile.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile

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

// dK and dV of one KV tile: K and V stay in shared memory, Q and dO tiles
// stream through it
template <int D, int BK, typename T>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int BH, int causal,
                     int round_p, float qscale) {
  constexpr int LD = D + 4;    // padded row stride of the operand tiles
  constexpr int LDP = BK + 4;  // padded row stride of the p and ds tiles
  constexpr int CJ = BK / 16;  // score columns, and kv rows, per thread
  constexpr int DJ = D / 64;   // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* Os = Qs + BQ * LD;    // the dO tile
  float* Ps = Os + BQ * LD;
  float* Ds = Ps + BQ * LDP;   // the ds tile
  float* Ls = Ds + BQ * LDP;   // base-2 lse of the Q tile's rows
  float* Es = Ls + BQ;         // delta of the Q tile's rows

  const int kt = (int)(blockIdx.x / BH);  // tile 0 sees every query: first
  const int bh = (int)(blockIdx.x % BH);
  const int k0 = kt * BK;
  const size_t head = (size_t)bh * S * D;
  const size_t rows = (size_t)bh * S;
  const int r = threadIdx.x >> 4;  // phase 1: query rows 4r..4r+3;
                                   // phase 2: kv rows CJ*r..CJ*r+CJ-1
  const int c = threadIdx.x & 15;  // phase 1: key columns c+16j;
                                   // phase 2: output columns 64jj+4c..+3

  load_tile<D>(Ks, LD, k + head + (size_t)k0 * D, BK, 1.f);
  load_tile<D>(Vs, LD, v + head + (size_t)k0 * D, BK, 1.f);

  float dka[CJ][DJ][4], dva[CJ][DJ][4];
#pragma unroll
  for (int i = 0; i < CJ; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) dka[i][jj][u] = dva[i][jj][u] = 0.f;

  const int n_q = S / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
    load_tile<D>(Qs, LD, q + head + (size_t)q0 * D, BQ, qscale);
    load_tile<D>(Os, LD, dout + head + (size_t)q0 * D, BQ, 1.f);
    if (threadIdx.x < BQ) {
      Ls[threadIdx.x] = lse[rows + q0 + threadIdx.x] * LOG2E;
      Es[threadIdx.x] = delta[rows + q0 + threadIdx.x];
    }
    __syncthreads();

    // phase 1: the p and ds tiles, [BQ, BK], into shared memory
    float s[4][CJ], dp[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<D, CJ>(s, Qs, Ks, LD, r, c);
    dot_rows<D, CJ>(dp, Os, Vs, LD, r, c);
    softmax_grad<CJ>(s, dp, Ls, Es, q0, k0,
                     causal && k0 + BK - 1 > q0, r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        Ps[(4 * r + i) * LDP + c + 16 * j] = round_bf16(s[i][j], round_p);
        Ds[(4 * r + i) * LDP + c + 16 * j] = round_bf16(dp[i][j], round_p);
      }
    __syncthreads();

    // phase 2: dv += p^T dO, dk += ds^T Q, one query row at a time
#pragma unroll 2
    for (int n = 0; n < BQ; ++n) {
      float pv[CJ], dsv[CJ];
      loadv<CJ>(pv, Ps + n * LDP + CJ * r);
      loadv<CJ>(dsv, Ds + n * LDP + CJ * r);
      float4 ov[DJ], qv[DJ];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        ov[jj] = *reinterpret_cast<const float4*>(Os + n * LD + 64 * jj +
                                                  4 * c);
        qv[jj] = *reinterpret_cast<const float4*>(Qs + n * LD + 64 * jj +
                                                  4 * c);
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

  // flush.  ds^T q2 = (scale*log2e) ds^T q, so ln2 restores scale ds^T q
#pragma unroll
  for (int i = 0; i < CJ; ++i) {
    const size_t at = head + (size_t)(k0 + CJ * r + i) * D;
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

// dQ of one Q tile: Q and dO stay in shared memory, K and V tiles stream
// through it
template <int D, int BK, typename T>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int BH, int causal, int round_p, float qscale,
                    float oscale) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 4;
  constexpr int CJ = BK / 16;
  constexpr int DJ = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + BQ * LD;
  float* Ks = Os + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ds = Vs + BK * LD;
  float* Ls = Ds + BQ * LDP;
  float* Es = Ls + BQ;

  const int n_q = S / BQ;
  const int qt = n_q - 1 - (int)(blockIdx.x / BH);  // the last tile sees
                                                    // every key: first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qt * BQ;
  const size_t head = (size_t)bh * S * D;
  const size_t rows = (size_t)bh * S;
  const int r = threadIdx.x >> 4;  // query rows 4r..4r+3, both phases
  const int c = threadIdx.x & 15;  // phase 1: key columns c+16j;
                                   // phase 2: output columns 64jj+4c..+3

  load_tile<D>(Qs, LD, q + head + (size_t)q0 * D, BQ, qscale);
  load_tile<D>(Os, LD, dout + head + (size_t)q0 * D, BQ, 1.f);
  if (threadIdx.x < BQ) {
    Ls[threadIdx.x] = lse[rows + q0 + threadIdx.x] * LOG2E;
    Es[threadIdx.x] = delta[rows + q0 + threadIdx.x];
  }

  float acc[4][DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.f;

  const int kv_tiles = causal ? (q0 + BQ) / BK : S / BK;
  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and ds are consumed
    load_tile<D>(Ks, LD, k + head + (size_t)k0 * D, BK, 1.f);
    load_tile<D>(Vs, LD, v + head + (size_t)k0 * D, BK, 1.f);
    __syncthreads();

    // phase 1: the ds tile, [BQ, BK], into shared memory
    float s[4][CJ], dp[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<D, CJ>(s, Qs, Ks, LD, r, c);
    dot_rows<D, CJ>(dp, Os, Vs, LD, r, c);
    softmax_grad<CJ>(s, dp, Ls, Es, q0, k0,
                     causal && k0 + BK - 1 > q0, r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ds[(4 * r + i) * LDP + c + 16 * j] = round_bf16(dp[i][j], round_p);
    __syncthreads();

    // phase 2: acc += ds K
#pragma unroll 2
    for (int n = 0; n < BK; n += 4) {
      float d[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) loadv<4>(d[i], Ds + (4 * r + i) * LDP + n);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 kv[DJ];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(
              Ks + (n + u) * LD + 64 * jj + 4 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj) {
            acc[i][jj][0] = fmaf(d[i][u], kv[jj].x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(d[i][u], kv[jj].y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(d[i][u], kv[jj].z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(d[i][u], kv[jj].w, acc[i][jj][3]);
          }
      }
    }
  }

  // flush: dq = scale * ds k
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dq + head + (size_t)(q0 + 4 * r + i) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      *reinterpret_cast<float4*>(row + 64 * jj + 4 * c) =
          make_float4(acc[i][jj][0] * oscale, acc[i][jj][1] * oscale,
                      acc[i][jj][2] * oscale, acc[i][jj][3] * oscale);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int bh, s, causal;
  float qscale;
  cudaStream_t stream;
};

template <int D, int BK, typename T>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  constexpr int smem =
      ((2 * BK + 2 * BQ) * (D + 4) + 2 * BQ * (BK + 4) + 2 * BQ) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, BK, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)a.bh * (unsigned)(a.s / BK));
  flash_bwd_dkv_kernel<D, BK, T><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, dk, dv, a.s, a.bh, a.causal,
      (int)(sizeof(T) == sizeof(__nv_bfloat16)), a.qscale);
  return cudaGetLastError();
}

template <int D, int BK, typename T>
cudaError_t launch_dq(const Args& a, float* dq, float oscale) {
  constexpr int smem =
      ((2 * BK + 2 * BQ) * (D + 4) + BQ * (BK + 4) + 2 * BQ) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BK, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)a.bh * (unsigned)(a.s / BQ));
  flash_bwd_dq_kernel<D, BK, T><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, dq, a.s, a.bh, a.causal,
      (int)(sizeof(T) == sizeof(__nv_bfloat16)), a.qscale, oscale);
  return cudaGetLastError();
}

bool bad_shape(int bh, int s, int dh) {
  return bh <= 0 || s <= 0 || s % BQ != 0 || (dh != 128 && dh != 256);
}

}  // namespace

// q, k, v, dout [bh, s, dh] (f32, or bf16 when bf16 != 0), lse and delta
// [bh, s] f32, dk and dv [bh, s, dh] f32.  Q is multiplied by qscale as it
// is loaded.  Launches on `stream` and returns the launch's cudaError_t (0
// on success).
extern "C" int t4_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int s, int dh, int causal, int bf16,
                                float qscale, void* stream) {
  if (bad_shape(bh, s, dh)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, s, causal, qscale,
               static_cast<cudaStream_t>(stream)};
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (dh == 128)
    return (int)(bf16 ? launch_dkv<128, 64, __nv_bfloat16>(a, dkf, dvf)
                      : launch_dkv<128, 64, float>(a, dkf, dvf));
  return (int)(bf16 ? launch_dkv<256, 32, __nv_bfloat16>(a, dkf, dvf)
                    : launch_dkv<256, 32, float>(a, dkf, dvf));
}

// as above, dq [bh, s, dh] f32 = oscale * ds k
extern "C" int t4_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int s,
                               int dh, int causal, int bf16, float qscale,
                               float oscale, void* stream) {
  if (bad_shape(bh, s, dh)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, s, causal, qscale,
               static_cast<cudaStream_t>(stream)};
  float* dqf = static_cast<float*>(dq);
  if (dh == 128)
    return (int)(bf16 ? launch_dq<128, 64, __nv_bfloat16>(a, dqf, oscale)
                      : launch_dq<128, 64, float>(a, dqf, oscale));
  return (int)(bf16 ? launch_dq<256, 32, __nv_bfloat16>(a, dqf, oscale)
                    : launch_dq<256, 32, float>(a, dqf, oscale));
}
