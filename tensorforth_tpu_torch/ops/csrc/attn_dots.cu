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
// and V, the TMA ring, thread 0's loads, the barriers and the grid order;
// at dh 384 to 1024 the hybrid forward's wide route (fwd_wide_body: a
// warpgroup per 128 columns of dh, the partial scores added in the CTA's
// shared memory in the order of ops/attn.py:cluster_sum, and by a pair of
// CTAs past dh 512, before their rounding to bf16).
// What is gone is the running max, the exp2, the row sums, the rescale of
// o, the final division and the lse.  s2 = q k^T takes the tensor cores'
// f32 sums over dh; p is s2 rounded to bf16 (cvt.rn); at dh 128 and 256
// each key tile's P V is a fresh accumulator added to o on the CUDA cores,
// on the wide route the tensor cores accumulate o over every key.  Values
// past the bf16 range (a chain that feeds o back as q) pass through as inf
// or NaN: nothing traps and nothing depends on them.
//
// Layout: q, k, v [B*h, S, dh] row-major bf16, 16-byte aligned; o [B*h,
// S, dh] f32.  S % 64 == 0, dh 128 to 1024 in steps of 128.
//
// What bounds it on this card: operations (4 dh per (query, key) pair at
// the 989 TFLOP/s of bf16 wgmma), as the hybrid forward.

#include "flash_fwd.cuh"

namespace {

// dh = D: 128 or 256 (the hybrid forward's body at its plan)
template <int D>
__global__ void __launch_bounds__(NT, 1)
    attn_dots_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     float* __restrict__ o, int S, int BH) {
  extern __shared__ unsigned char smem_raw[];
  fwd_body<D, 1, true>(smem_raw, &mq, &mk, &mv, o, nullptr, S, BH, 0, 1.f);
}

// dh = D, 384 to 1024: the wide route (a CTA of dh / 128 warpgroups, a
// pair of CTAs of four past dh 512)
template <int D>
__global__ void __launch_bounds__(Wide<D>::THREADS, 1)
    attn_dots_wide_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          float* __restrict__ o, int S, int BH) {
  extern __shared__ unsigned char smem_raw[];
  fwd_wide_body<D, true>(smem_raw, &mq, &mk, &mv, o, nullptr, S, BH, 0, 1.f);
}

template <int D>
int launch_dots(const void* q, const void* k, const void* v, float* o,
                int bh, int s, cudaStream_t stream) {
  CUtensorMap m[3];
  if constexpr (D <= 256) {
    const int e = fwd_maps<D, 1>(q, k, v, bh, s, m);
    if (e != 0) return e;
    return launch(attn_dots_kernel<D>, fwd_grid<D, 1>(bh, s), NT,
                  Fwd<D, 1>::SMEM, stream, m[0], m[1], m[2], o, s, bh);
  } else {
    const int e = wide_maps<D>(q, k, v, bh, s, m);
    if (e != 0) return e;
    return launch_cluster(attn_dots_wide_kernel<D>, wide_grid<D>(bh, s),
                          Wide<D>::CL, Wide<D>::THREADS, Wide<D>::SMEM,
                          stream, m[0], m[1], m[2], o, s, bh);
  }
}

template <int D>
int dots_clusters(int* n) {
  if constexpr (D <= 256)
    return max_clusters(attn_dots_kernel<D>, 1, NT, Fwd<D, 1>::SMEM, n);
  else
    return max_clusters(attn_dots_wide_kernel<D>, Wide<D>::CL,
                        Wide<D>::THREADS, Wide<D>::SMEM, n);
}

}  // namespace

// q, k, v [bh, s, dh] bf16, 16-byte aligned; o [bh, s, dh] f32; dh 128 to
// 1024 in steps of 128 (dh 1152 and wider are refused, as every kernel of
// the port refuses them).  Launches on `stream` and returns the launch's cudaError_t (0 on
// success).
extern "C" int t4_attn_dots(const void* q, const void* k, const void* v,
                            void* o, int bh, int s, int dh, void* stream) {
  if (bh <= 0 || s <= 0 || s % 64 != 0 || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 128: return launch_dots<128>(q, k, v, of, bh, s, st);
    case 256: return launch_dots<256>(q, k, v, of, bh, s, st);
    case 384: return launch_dots<384>(q, k, v, of, bh, s, st);
    case 512: return launch_dots<512>(q, k, v, of, bh, s, st);
    case 640: return launch_dots<640>(q, k, v, of, bh, s, st);
    case 768: return launch_dots<768>(q, k, v, of, bh, s, st);
    case 896: return launch_dots<896>(q, k, v, of, bh, s, st);
    case 1024: return launch_dots<1024>(q, k, v, of, bh, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the most clusters of the probe's route at dh that the card runs at once,
// into *n (an int; one CTA a cluster to dh 512, a pair past it); the
// query's cudaError_t
extern "C" int t4_attn_dots_clusters(int dh, void* n) {
  int* out = static_cast<int*>(n);
  switch (dh) {
    case 128: return dots_clusters<128>(out);
    case 256: return dots_clusters<256>(out);
    case 384: return dots_clusters<384>(out);
    case 512: return dots_clusters<512>(out);
    case 640: return dots_clusters<640>(out);
    case 768: return dots_clusters<768>(out);
    case 896: return dots_clusters<896>(out);
    case 1024: return dots_clusters<1024>(out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
