// The dots-only probe of the flash-attention forward for Hopper (sm_90a):
// the forward kernel's two products with the softmax taken out.
//
// Replaces the Pallas kernel inside bench.py:_attn_dots_probe.  Per
// (batch*head) it computes, from bf16 q, k, v,
//   s2 = q k^T          (f32 sums; no scale, no mask)
//   o  = bf16(s2) v     (f32 sums over the keys in index order)
// The probe's meaning is the gap between it and the real forward, so it
// has flash_fwd.cu's block structure, to the line: one 256-thread block per
// (head, 64-row query tile), K and V streaming through shared memory in
// 64-row tiles, the same dot_rows / accum_rows FMAs on the CUDA cores, the
// same bf16 loads as the forward's hybrid mode, the same barriers.  What is
// gone is the running max, the exp2, the rescale of the accumulator and the
// final division.  A tensor-core version would answer another question.
//
// Layout: q, k, v [B*h, S, dh] row-major bf16; o [B*h, S, dh] f32.
// S % 64 == 0, dh in {128, 256}.
//
// What bounds it on this card: operations (4 * dh per (query, key) pair at
// the 67 TFLOP/s of the f32 CUDA cores), as the forward.

#include "flash_tile.cuh"

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // key/value rows per tile

template <int D>
__global__ void __launch_bounds__(NT, D <= 128 ? 2 : 1)
attn_dots_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
                 int S, int BH) {
  constexpr int LDQ = D + 4;   // padded row stride of the Q and K tiles
  constexpr int LDP = BN + 4;  // padded row stride of the score tile
  constexpr int DJ = D / 64;   // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * LDQ;
  float* Vs = Ks + BN * LDQ;
  float* Ps = Ks;              // the scores overwrite K once they are out

  const int n_tiles = S / BM;
  const int qt = (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qt * BM;
  const size_t head = (size_t)bh * S * D;
  const int r = threadIdx.x >> 4;  // query rows 4r..4r+3 of the tile
  const int c = threadIdx.x & 15;  // key columns c+16j; output columns
                                   // 64jj+4c..64jj+4c+3

  load_tile<D>(Qs, LDQ, q + head + (size_t)q0 * D, BM, 1.f);

  float acc[4][DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const size_t k0 = (size_t)kt * BN;
    __syncthreads();  // the previous tile's scores and V are consumed
    load_tile<D>(Ks, LDQ, k + head + k0 * D, BN, 1.f);
    load_tile<D>(Vs, D, v + head + k0 * D, BN, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    dot_rows<D, 4>(s, Qs, Ks, LDQ, r, c);

    __syncthreads();  // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * r + i) * LDP + c + 16 * j] = round_bf16(s[i][j], 1);
    __syncthreads();

    accum_rows<D, BN>(acc, Ps, LDP, Vs, D, r, c);  // acc += bf16(s2) V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* orow = o + head + (size_t)(q0 + 4 * r + i) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      *reinterpret_cast<float4*>(orow + 64 * jj + 4 * c) =
          make_float4(acc[i][jj][0], acc[i][jj][1], acc[i][jj][2],
                      acc[i][jj][3]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, float* o,
                   int bh, int s, cudaStream_t stream) {
  constexpr int smem = (BM * (D + 4) + BN * (D + 4) + BN * D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attn_dots_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)bh * (unsigned)(s / BM));
  attn_dots_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), o, s, bh);
  return cudaGetLastError();
}

}  // namespace

// q, k, v [bh, s, dh] bf16, o [bh, s, dh] f32.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int t4_attn_dots(const void* q, const void* k, const void* v,
                            void* o, int bh, int s, int dh, void* stream) {
  if (bh <= 0 || s <= 0 || s % BM != 0) return (int)cudaErrorInvalidValue;
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return (int)launch<128>(q, k, v, of, bh, s, st);
  if (dh == 256) return (int)launch<256>(q, k, v, of, bh, s, st);
  return (int)cudaErrorInvalidValue;
}
