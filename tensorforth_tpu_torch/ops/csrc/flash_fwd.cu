// Causal/non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces tensorforth_tpu/ops/attn_pallas.py:_flash_kernel (launched by
// flash_attention).  Computes, per (batch*head) and query row,
//   o = softmax(q k^T / sqrt(dh)) v   and   lse = logsumexp(q k^T / sqrt(dh))
// in nats, with an optional causal mask (key position <= query position).
// The S x S score matrix never reaches device memory.
//
// Layout: q, k, v [B*h, S, dh] row-major (f32, or bf16 in hybrid mode);
// o [B*h, S, dh] f32; lse [B*h, S] f32.  S % 64 == 0, dh in {128, 256}.
//
// What bounds it on this card: operations.  At the serving slice's shape
// (B*h=64, S=2048, dh=128, causal) it does ~69 GFLOP against ~270 MB of
// q/k/v/o traffic, about 250 FLOP per byte; and it runs its f32 products
// on the CUDA cores (67 TFLOP/s peak), since the serving numerics are
// strict f32 and TF32 tensor cores would keep only ten mantissa bits.
// The design keeps the FMA units fed from shared memory:
//   * one 256-thread block per (head, 64-row query tile); K and V stream
//     through shared memory in 64-row tiles, and each thread holds a 4x4
//     block of scores and a 4 x dh/16 block of the output accumulator in
//     registers, so each shared-memory read feeds 4-8 FMAs;
//   * rows padded by 4 floats make the float4 reads of Q and K rows free
//     of bank conflicts; P reuses K's buffer, which leaves 98 KB of
//     shared memory per block at dh=128, so two blocks share an SM;
//   * online softmax in the base-2 domain: scale*log2(e) is folded into
//     Q as it is loaded, so each score costs one exp2 and no multiply
//     (attn_pallas.py:313-316 does the same outside its kernel);
//   * causal blocks stop at the diagonal tile, and the grid hands out the
//     longest (last) query tiles first so the tail of the launch is short.
// wgmma, TMA and a multi-stage load pipeline are later work.
//
// Hybrid mode (T4_ATTN_HYBRID=1): q (already scaled), k, v arrive as bf16
// and P is rounded to bf16 before the PV product, as the Pallas kernel's
// bf16 multiplicands are; products and sums stay f32.

#include "flash_tile.cuh"

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // key/value rows per tile

template <int D, typename T>
__global__ void __launch_bounds__(NT, D <= 128 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int BH, int causal,
                 int round_p, float qscale) {
  constexpr int LDQ = D + 4;   // padded row stride of the Q and K tiles
  constexpr int LDP = BN + 4;  // padded row stride of the P tile
  constexpr int DJ = D / 64;   // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * LDQ;
  float* Vs = Ks + BN * LDQ;
  float* Ps = Ks;              // P overwrites K once the scores are out

  const int n_tiles = S / BM;
  const int qt = n_tiles - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qt * BM;
  const size_t head = (size_t)bh * S * D;
  const int r = threadIdx.x >> 4;  // query rows 4r..4r+3 of the tile
  const int c = threadIdx.x & 15;  // key columns c+16j; output columns
                                   // 64jj+4c..64jj+4c+3

  load_tile<D>(Qs, LDQ, q + head + (size_t)q0 * D, BM, qscale);

  float m[4], l[4], acc[4][DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.f;
  }

  const int kv_tiles = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kv_tiles; ++kt) {
    const size_t k0 = (size_t)kt * BN;
    __syncthreads();  // the previous tile's P and V are consumed
    load_tile<D>(Ks, LDQ, k + head + k0 * D, BN, 1.f);
    load_tile<D>(Vs, D, v + head + k0 * D, BN, 1.f);
    __syncthreads();

    // base-2 scores of rows 4r+i against keys c+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    dot_rows<D, 4>(s, Qs, Ks, LDQ, r, c);
    if (causal && kt == qt) {  // the diagonal tile: k0 == q0
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + 16 * j > 4 * r + i) s[i][j] = NEG_INF;
    }

    // online softmax.  Every tile the loop visits holds an unmasked key
    // for every row (key k0 <= q0), so m is finite after the first tile
    // and exp2(NEG_INF - m) is 0, never exp2(0).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;  // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][jj][u] *= alpha;
    }

    __syncthreads();  // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * r + i) * LDP + c + 16 * j] =
            round_p ? __bfloat162float(__float2bfloat16(s[i][j])) : s[i][j];
    __syncthreads();

    accum_rows<D, BN>(acc, Ps, LDP, Vs, D, r, c);  // acc += P V
  }

  // flush: the row sum is spread over the 16 lanes of the row group
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + 4 * r + i;
    float* orow = o + head + (size_t)row * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      *reinterpret_cast<float4*>(orow + 64 * jj + 4 * c) =
          make_float4(acc[i][jj][0] / lt, acc[i][jj][1] / lt,
                      acc[i][jj][2] / lt, acc[i][jj][3] / lt);
    if (c == 0) lse[(size_t)bh * S + row] = (m[i] + log2f(lt)) * LN2;
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, float* o,
                   float* lse, int bh, int s, int causal, int round_p,
                   float qscale, cudaStream_t stream) {
  constexpr int smem = (BM * (D + 4) + BN * (D + 4) + BN * D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)bh * (unsigned)(s / BM));
  flash_fwd_kernel<D, T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, lse, s, bh, causal, round_p, qscale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v [bh, s, dh] (f32, or bf16 when bf16 != 0), o [bh, s, dh] f32,
// lse [bh, s] f32.  Q is multiplied by qscale as it is loaded.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int t4_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int s, int dh,
                            int causal, int bf16, float qscale,
                            void* stream) {
  if (bh <= 0 || s <= 0 || s % BM != 0) return (int)cudaErrorInvalidValue;
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128)
    return (int)(bf16 ? launch<128, __nv_bfloat16>(q, k, v, of, lf, bh, s,
                                                    causal, 1, qscale, st)
                      : launch<128, float>(q, k, v, of, lf, bh, s, causal, 0,
                                           qscale, st));
  if (dh == 256)
    return (int)(bf16 ? launch<256, __nv_bfloat16>(q, k, v, of, lf, bh, s,
                                                    causal, 1, qscale, st)
                      : launch<256, float>(q, k, v, of, lf, bh, s, causal, 0,
                                           qscale, st));
  return (int)cudaErrorInvalidValue;
}
