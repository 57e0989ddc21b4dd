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

#include "flash_bwd_tile.cuh"

namespace {

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
    load_q_side<D>(Qs, Os, Ls, Es, q + head, dout + head, lse + rows,
                   delta + rows, q0, qscale);
    __syncthreads();
    pds_tiles<D, BK, true>(Qs, Os, Ks, Vs, Ls, Es, Ps, Ds, q0, k0,
                           causal && k0 + BK - 1 > q0, round_p, r, c);
    __syncthreads();
    accum_dkv<D, BK>(dka, dva, Ps, Ds, Os, Qs, r, c);
  }
  store_dkv<D, BK>(dka, dva, dk + head, dv + head, k0, r, c);
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

  load_q_side<D>(Qs, Os, Ls, Es, q + head, dout + head, lse + rows,
                 delta + rows, q0, qscale);

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
    pds_tiles<D, BK, false>(Qs, Os, Ks, Vs, Ls, Es, nullptr, Ds, q0, k0,
                            causal && k0 + BK - 1 > q0, round_p, r, c);
    __syncthreads();
    accum_rows<D, BK>(acc, Ds, LDP, Ks, LD, r, c);  // acc += ds K
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

template <int D, int BK, typename T>
cudaError_t launch_dkv(const BwdArgs& a, float* dk, float* dv) {
  constexpr int smem = bwd_smem_floats(D, BK, true) * sizeof(float);
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
cudaError_t launch_dq(const BwdArgs& a, float* dq, float oscale) {
  constexpr int smem = bwd_smem_floats(D, BK, false) * sizeof(float);
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
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
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
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, s, causal, qscale,
               static_cast<cudaStream_t>(stream)};
  float* dqf = static_cast<float*>(dq);
  if (dh == 128)
    return (int)(bf16 ? launch_dq<128, 64, __nv_bfloat16>(a, dqf, oscale)
                      : launch_dq<128, 64, float>(a, dqf, oscale));
  return (int)(bf16 ? launch_dq<256, 32, __nv_bfloat16>(a, dqf, oscale)
                    : launch_dq<256, 32, float>(a, dqf, oscale));
}
