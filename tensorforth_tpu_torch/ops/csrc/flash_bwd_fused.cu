// Flash-attention backward for Hopper (sm_90a) in ONE kernel: dQ, dK, dV
// with five products per visited (Q tile, KV tile) pair.
//
// Replaces tensorforth_tpu/ops/attn_pallas.py:_flash_bwd_fused_kernel
// (launched by flash_attention_bwd_fused).  The arithmetic is that of
// flash_bwd.cu (see its header), but s2 = q2 k^T and dp = do v^T are
// computed once per pair and feed all three gradients, where the two-kernel
// split computes them in both kernels (seven products):
//   p = exp2(s2 - lse2),  ds = p * (dp - delta)
//   dq += ds k,   dv_part = p^T do,   dk_part = ln2 * ds^T q2
// The price is the TPU kernel's: a block owns a Q BLOCK of `bq` rows (the
// caller's choice; n_q = S / bq), and dK and dV leave as per-Q-block
// partials [B*h, n_q, S, dh] f32 that one sum over n_q outside the kernel
// turns into dK and dV.
//
// Layout: q, k, v, do [B*h, S, dh] row-major (f32, or bf16 in hybrid
// mode); lse, delta [B*h, S] f32; dq [B*h, S, dh] f32; dkp, dvp
// [B*h, n_q, S, dh] f32.  S % bq == 0, bq % 64 == 0, dh in {128, 256}.
//
// What bounds it on this card: operations, as the split (strict-f32 FMAs
// on the CUDA cores, 67 TFLOP/s peak): 5 products of 2*dh operations per
// pair against q, k, v, do read once and 2*n_q*B*h*S*dh*4 bytes of partials
// written here and read by the sum.  The design:
//   * one 256-thread block per (head, Q block), and inside it the order
//     KV tile (outer) -> the Q block's 64-row tiles (inner).  K and V stay
//     in shared memory for the inner loop, and the thread's dK/dV rows stay
//     in REGISTERS across it, so each partial element is stored once, when
//     its KV tile is done.  Tiles and thread layout are flash_bwd.cu's
//     (BK = 64 at dh 128, 32 at dh 256; 170 KB / 219 KB of shared memory,
//     one block per SM);
//   * a Q block's dq (bq x dh f32: 512 KB at bq = 1024) does not fit
//     shared memory.  Each pair's 64 x dh product ds k is formed in
//     registers and added into the block's own rows of global dq by plain
//     load, add, store.  A dq element has one writer in the whole grid,
//     the same thread in every pair, so program order is enough; the first
//     KV tile stores without loading and the last one a row sees stores
//     times `oscale`;
//   * EVERY OUTPUT ELEMENT HAS EXACTLY ONE WRITER: no atomics, so results
//     repeat from run to run.  Under the causal mask a KV tile that lies
//     wholly after the Q block is never visited and the block writes zeros
//     to those rows of its partials; inside the Q block the inner loop
//     starts at the first tile that sees the KV tile;
//   * the causal load grows with the Q block's index, so the grid hands
//     out the last Q blocks first.
// The grid is B*h * n_q blocks.  With bq in the hundreds that is few for
// 132 SMs unless B*h is large: the larger bq is, the less partial traffic
// and the fewer blocks.  wgmma, TMA and a split of the KV range over a
// cluster are later work.
//
// Hybrid mode: as flash_bwd.cu (bf16 loads; p and ds rounded to bf16 before
// their products, ds formed from the unrounded p; f32 products and sums).

#include "flash_bwd_tile.cuh"

namespace {

template <int D, int BK, typename T>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       float* __restrict__ dkp, float* __restrict__ dvp, int S,
                       int BH, int bq, int causal, int round_p, float qscale,
                       float oscale) {
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

  const int n_q = S / bq;
  const int qi = n_q - 1 - (int)(blockIdx.x / BH);  // the last Q block sees
                                                    // every key: first
  const int bh = (int)(blockIdx.x % BH);
  const int qb0 = qi * bq;          // the Q block's rows: qb0 .. qb0+bq-1
  const size_t head = (size_t)bh * S * D;
  const size_t rows = (size_t)bh * S;
  const size_t part = ((size_t)bh * n_q + qi) * S * D;  // its partial slabs
  const int r = threadIdx.x >> 4;  // phase 1: query rows 4r..4r+3;
                                   // dK/dV: kv rows CJ*r..CJ*r+CJ-1;
                                   // dQ: query rows 4r..4r+3
  const int c = threadIdx.x & 15;  // phase 1: key columns c+16j;
                                   // dK/dV, dQ: output columns 64jj+4c..+3

  const int kv_rows = causal ? qb0 + bq : S;  // keys the Q block sees
  for (int k0 = 0; k0 < kv_rows; k0 += BK) {
    __syncthreads();  // the previous KV tile's K is consumed (dq product)
    load_tile<D>(Ks, LD, k + head + (size_t)k0 * D, BK, 1.f);
    load_tile<D>(Vs, LD, v + head + (size_t)k0 * D, BK, 1.f);

    float dka[CJ][DJ][4], dva[CJ][DJ][4];
#pragma unroll
    for (int i = 0; i < CJ; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
        for (int u = 0; u < 4; ++u) dka[i][jj][u] = dva[i][jj][u] = 0.f;

    // the Q block's tiles that see this KV tile: q0 + BQ - 1 >= k0
    const int q_first = causal ? max(qb0, k0 / BQ * BQ) : qb0;
    for (int q0 = q_first; q0 < qb0 + bq; q0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
      load_q_side<D>(Qs, Os, Ls, Es, q + head, dout + head, lse + rows,
                     delta + rows, q0, qscale);
      __syncthreads();
      pds_tiles<D, BK, true>(Qs, Os, Ks, Vs, Ls, Es, Ps, Ds, q0, k0,
                             causal && k0 + BK - 1 > q0, round_p, r, c);
      __syncthreads();
      accum_dkv<D, BK>(dka, dva, Ps, Ds, Os, Qs, r, c);

      // this pair's share of dq, added into the block's own rows
      float acc[4][DJ][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.f;
      accum_rows<D, BK>(acc, Ds, LDP, Ks, LD, r, c);  // ds K
      const bool first = k0 == 0;
      // the last KV tile that this Q tile sees flushes times oscale
      const float flush =
          k0 == (causal ? q0 + BQ - BK : S - BK) ? oscale : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = dq + head + (size_t)(q0 + 4 * r + i) * D;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          float4* at = reinterpret_cast<float4*>(row + 64 * jj + 4 * c);
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          if (!first) t = *at;
          *at = make_float4((t.x + acc[i][jj][0]) * flush,
                            (t.y + acc[i][jj][1]) * flush,
                            (t.z + acc[i][jj][2]) * flush,
                            (t.w + acc[i][jj][3]) * flush);
        }
      }
    }
    store_dkv<D, BK>(dka, dva, dkp + part, dvp + part, k0, r, c);
  }

  // KV rows after the Q block (causal): never visited, written as zeros
  const size_t from = part + (size_t)kv_rows * D;
  const int n4 = (S - kv_rows) * (D / 4);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < n4; i += NT) {
    reinterpret_cast<float4*>(dkp + from)[i] = zero;
    reinterpret_cast<float4*>(dvp + from)[i] = zero;
  }
}

template <int D, int BK, typename T>
cudaError_t launch_fused(const BwdArgs& a, int bq, float* dq, float* dkp,
                         float* dvp, float oscale) {
  constexpr int smem = bwd_smem_floats(D, BK, true) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<D, BK, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)a.bh * (unsigned)(a.s / bq));
  flash_bwd_fused_kernel<D, BK, T><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, dq, dkp, dvp, a.s, a.bh, bq, a.causal,
      (int)(sizeof(T) == sizeof(__nv_bfloat16)), a.qscale, oscale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout [bh, s, dh] (f32, or bf16 when bf16 != 0), lse and delta
// [bh, s] f32, dq [bh, s, dh] f32, dkp and dvp [bh, s / bq, s, dh] f32.  Q
// is multiplied by qscale as it is loaded and dq = oscale * ds k.  Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int t4_flash_bwd_fused(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dkp,
                                  void* dvp, int bh, int s, int dh, int bq,
                                  int causal, int bf16, float qscale,
                                  float oscale, void* stream) {
  if (bh <= 0 || s <= 0 || bq <= 0 || bq % BQ != 0 || s % bq != 0 ||
      (dh != 128 && dh != 256))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), bh, s, causal, qscale,
                  static_cast<cudaStream_t>(stream)};
  float* dqf = static_cast<float*>(dq);
  float* kp = static_cast<float*>(dkp);
  float* vp = static_cast<float*>(dvp);
  if (dh == 128)
    return (int)(bf16
                     ? launch_fused<128, 64, __nv_bfloat16>(a, bq, dqf, kp, vp,
                                                            oscale)
                     : launch_fused<128, 64, float>(a, bq, dqf, kp, vp,
                                                    oscale));
  return (int)(bf16 ? launch_fused<256, 32, __nv_bfloat16>(a, bq, dqf, kp, vp,
                                                           oscale)
                    : launch_fused<256, 32, float>(a, bq, dqf, kp, vp,
                                                   oscale));
}
