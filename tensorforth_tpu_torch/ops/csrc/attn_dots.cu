// The dots-only probe of the flash-attention forward for Hopper (sm_90a):
// the forward kernel's body with the softmax compiled out.
//
// Replaces the Pallas kernel inside bench.py:_attn_dots_probe (line 692).
// Per (batch*head) it computes, from bf16 q, k, v,
//   o = sum over the key tiles of bf16(q k^T)[:, tile] v[tile]
// in f32: no scale, no mask, no softmax.  The probe's meaning is the gap
// between it and the real forward, so it is the forward's own body
// (flash_fwd.cuh, DOTS set) at the hybrid class's plan, to the line: the
// tiles (BQ 128 / BKV 64 at dh 128, 64 / 32 at dh 256), two stages of K
// and V, the TMA ring, thread 0's loads, the barriers and the grid order.
// What is gone is the running max, the exp2, the row sums, the rescale of
// o, the final division and the lse.  s2 = q k^T takes the tensor cores'
// f32 sums over dh; p is s2 rounded to bf16 (cvt.rn); each key tile's
// P V is a fresh accumulator added to o on the CUDA cores.  Values past
// the bf16 range (a chain that feeds o back as q) pass through as inf or
// NaN: nothing traps and nothing depends on them.
//
// Layout: q, k, v [B*h, S, dh] row-major bf16, 16-byte aligned; o [B*h,
// S, dh] f32.  S % 64 == 0, dh in {128, 256}.
//
// What bounds it on this card: operations (4 dh per (query, key) pair at
// the 989 TFLOP/s of bf16 wgmma), as the hybrid forward.

#include "flash_fwd.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(NT, 1)
    attn_dots_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     float* __restrict__ o, int S, int BH) {
  extern __shared__ unsigned char smem_raw[];
  fwd_body<D, 1, true>(smem_raw, &mq, &mk, &mv, o, nullptr, S, BH, 0, 1.f);
}

template <int D>
int launch_dots(const void* q, const void* k, const void* v, float* o,
                int bh, int s, cudaStream_t stream) {
  CUtensorMap m[3];
  const int e = fwd_maps<D, 1>(q, k, v, bh, s, m);
  if (e != 0) return e;
  return launch(attn_dots_kernel<D>, fwd_grid<D, 1>(bh, s), NT,
                Fwd<D, 1>::SMEM, stream, m[0], m[1], m[2], o, s, bh);
}

}  // namespace

// q, k, v [bh, s, dh] bf16, 16-byte aligned; o [bh, s, dh] f32.  Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int t4_attn_dots(const void* q, const void* k, const void* v,
                            void* o, int bh, int s, int dh, void* stream) {
  if (bh <= 0 || s <= 0 || s % 64 != 0 || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return launch_dots<128>(q, k, v, of, bh, s, st);
  if (dh == 256) return launch_dots<256>(q, k, v, of, bh, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
