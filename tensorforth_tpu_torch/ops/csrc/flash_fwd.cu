// Causal/non-causal flash-attention forward for Hopper (sm_90a): its two
// products on the tensor cores through wgmma, fed by TMA.
//
// Replaces tensorforth_tpu/ops/attn_pallas.py:_flash_kernel (line 74;
// launched by flash_attention).  Computes, per (batch*head) and query row,
//   o = softmax(q k^T / sqrt(dh)) v   and   lse = logsumexp(q k^T / sqrt(dh))
// in nats, with an optional causal mask (key position <= query position),
// in the base-2 domain: the wrapper folds scale*log2(e) into q
// (attn_pallas.py:313-316 does the same outside its kernel).  The S x S
// score matrix never reaches device memory.
//
// Layout: q, k, v each [NP, B*h, S, dh] bf16 parts, row-major; o
// [B*h, S, dh] f32; lse [B*h, S] f32.  S % 64 == 0, dh in {128, 256, ...,
// 1024} (a multiple of 128): at 384 to 1024 the f32 class on a cluster of
// dh / 128 CTAs that split dh and add their partial scores, the hybrid
// class on the wide route, whose warpgroups split dh and add their
// partial scores in the CTA's shared memory (one CTA to dh 512, a pair
// past it; flash_fwd.cuh).
//
// Two classes, one kernel (NP, the parts of each operand):
//   f32 (NP 3): q*scale*log2e, k and v arrive split into three bf16 parts
//     each (t4_split_qkv below: x = hi + mid + lo exactly, split_bf16.cuh),
//     and each product is six bf16 products, smallest first: lo hi, mid
//     mid, hi lo, mid hi, hi mid, hi hi, each over the whole reduction
//     before the next (the tensor cores' adds truncate; the small terms go
//     in while the sum is small).  p is split the same way in registers.
//     Three parts are what holds the class: three products of two parts
//     (K5a 3pass's) reach 0.43-0.82 of the reference's f32 tolerance
//     (2e-5 + 2e-5 |x|) before any rounding of the sums, six 0.002
//     (tests/test_torch_split6.py).
//   hybrid (NP 1): the wrapper's bf16 casts, one product; p rounds to bf16
//     (cvt.rn) before the PV product, as the Pallas kernel's bf16
//     multiplicands do.
//
// What bounds it on this card: operations.  At the serving slice's shape
// ([64, 2048, 128] causal) the two products are 68.75 GFLOP, six times that
// in the f32 class: 0.417 ms at the 989 TFLOP/s of bf16 wgmma, against
// 0.08 ms for its bytes (the f32 class's split parts read once, o and lse
// written once).
//
// The body (tiles, loads, products, the online softmax) is in
// flash_fwd.cuh, which K8, the dots-only probe (attn_dots.cu), shares with
// the softmax compiled out.

#include "flash_fwd.cuh"

namespace {

// CL > 1: launched in clusters of CL CTAs that split dh
template <int D, int NP, int CL>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     float* __restrict__ o, float* __restrict__ lse, int S,
                     int BH, int causal, float qscale) {
  extern __shared__ unsigned char smem_raw[];
  fwd_body<D, NP, false, CL>(smem_raw, &mq, &mk, &mv, o, lse, S, BH,
                             causal, qscale);
}

// the hybrid class at dh 384 to 1024: the wide route, a CTA of dh / 128
// warpgroups (a pair of CTAs of four past dh 512)
template <int D>
__global__ void __launch_bounds__(Wide<D>::THREADS, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          float* __restrict__ o, float* __restrict__ lse,
                          int S, int BH, int causal, float qscale) {
  extern __shared__ unsigned char smem_raw[];
  fwd_wide_body<D, false>(smem_raw, &mq, &mk, &mv, o, lse, S, BH, causal,
                          qscale);
}

template <int D>
int launch_wide(const void* q, const void* k, const void* v, float* o,
                float* lse, int bh, int s, int causal, int bq, int bkv,
                int stages, int smem, int cluster, float qscale,
                cudaStream_t stream) {
  using W = Wide<D>;
  if (bq != W::BQ || bkv != W::BKV || stages != W::KST || smem != W::SMEM ||
      cluster != W::CL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3];
  const int e = wide_maps<D>(q, k, v, bh, s, m);
  if (e != 0) return e;
  return launch_cluster(flash_fwd_wide_kernel<D>, wide_grid<D>(bh, s), W::CL,
                        W::THREADS, W::SMEM, stream, m[0], m[1], m[2], o,
                        lse, s, bh, causal, qscale);
}

template <int D, int NP, int CL>
int launch_fwd(const void* q, const void* k, const void* v, float* o,
               float* lse, int bh, int s, int causal, int bq, int bkv,
               int stages, int smem, int cluster, float qscale,
               cudaStream_t stream) {
  using P = Fwd<D, NP, CL>;
  if (bq != P::BQ || bkv != P::BKV || stages != P::ST || smem != P::SMEM ||
      cluster != CL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3];
  const int e = fwd_maps<D, NP, CL>(q, k, v, bh, s, m);
  if (e != 0) return e;
  return launch_cluster(flash_fwd_kernel<D, NP, CL>,
                        fwd_grid<D, NP, CL>(bh, s), CL, NT, P::SMEM, stream,
                        m[0], m[1], m[2], o, lse, s, bh, causal, qscale);
}

}  // namespace

// q, k, v [parts, bh, s, dh] bf16 (parts 3: hi, mid, lo from t4_split_qkv,
// the f32 class; 1: the hybrid class's casts), 16-byte aligned; o [bh, s,
// dh] f32, lse [bh, s] f32.  The scores are qscale (q k^T): the wrappers
// fold the scale into q and pass 1.  (bq, bkv, stages, smem, cluster) name
// the tile plan (ops/attn.py:fwd_plan); one the library was not built with
// is refused, and so is dh 1152 or wider (the hybrid class at dh 384 to
// 1024: stages are K's, cluster 1 or 2).  Launches on `stream` and returns
// the launch's cudaError_t (0 on success).
extern "C" int t4_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int s, int dh,
                            int causal, int parts, int bq, int bkv,
                            int stages, int smem, int cluster, float qscale,
                            void* stream) {
  if (bh <= 0 || s <= 0 || s % 64 != 0 || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define T4_FWD(D, NP, CL)                                                  \
  launch_fwd<D, NP, CL>(q, k, v, of, lf, bh, s, causal, bq, bkv, stages,   \
                        smem, cluster, qscale, st)
#define T4_WIDE(D)                                                         \
  launch_wide<D>(q, k, v, of, lf, bh, s, causal, bq, bkv, stages, smem,    \
                 cluster, qscale, st)
  if (dh == 128 && parts == 3) return T4_FWD(128, 3, 1);
  if (dh == 128 && parts == 1) return T4_FWD(128, 1, 1);
  if (dh == 256 && parts == 3) return T4_FWD(256, 3, 1);
  if (dh == 256 && parts == 1) return T4_FWD(256, 1, 1);
  if (dh == 384 && parts == 3) return T4_FWD(384, 3, 3);
  if (dh == 384 && parts == 1) return T4_WIDE(384);
  if (dh == 512 && parts == 3) return T4_FWD(512, 3, 4);
  if (dh == 512 && parts == 1) return T4_WIDE(512);
  if (dh == 640 && parts == 3) return T4_FWD(640, 3, 5);
  if (dh == 640 && parts == 1) return T4_WIDE(640);
  if (dh == 768 && parts == 3) return T4_FWD(768, 3, 6);
  if (dh == 768 && parts == 1) return T4_WIDE(768);
  if (dh == 896 && parts == 3) return T4_FWD(896, 3, 7);
  if (dh == 896 && parts == 1) return T4_WIDE(896);
  if (dh == 1024 && parts == 3) return T4_FWD(1024, 3, 8);
  if (dh == 1024 && parts == 1) return T4_WIDE(1024);
#undef T4_FWD
#undef T4_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}

// the most clusters of the forward's route at (dh, parts) that the card
// runs at once, into *n (1 CTA a cluster at dh 128 and 256, and on the
// hybrid class's wide route to dh 512; a pair past it); 0 or the query's
// cudaError_t
extern "C" int t4_flash_fwd_clusters(int dh, int parts, void* n) {
  int* out = static_cast<int*>(n);
#define T4_FWD_CL(D, NP, CL) \
  max_clusters(flash_fwd_kernel<D, NP, CL>, CL, NT, Fwd<D, NP, CL>::SMEM, out)
#define T4_WIDE_CL(D)                                                    \
  max_clusters(flash_fwd_wide_kernel<D>, Wide<D>::CL, Wide<D>::THREADS,  \
               Wide<D>::SMEM, out)
  if (dh == 128 && parts == 3) return T4_FWD_CL(128, 3, 1);
  if (dh == 128 && parts == 1) return T4_FWD_CL(128, 1, 1);
  if (dh == 256 && parts == 3) return T4_FWD_CL(256, 3, 1);
  if (dh == 256 && parts == 1) return T4_FWD_CL(256, 1, 1);
  if (dh == 384 && parts == 3) return T4_FWD_CL(384, 3, 3);
  if (dh == 384 && parts == 1) return T4_WIDE_CL(384);
  if (dh == 512 && parts == 3) return T4_FWD_CL(512, 3, 4);
  if (dh == 512 && parts == 1) return T4_WIDE_CL(512);
  if (dh == 640 && parts == 3) return T4_FWD_CL(640, 3, 5);
  if (dh == 640 && parts == 1) return T4_WIDE_CL(640);
  if (dh == 768 && parts == 3) return T4_FWD_CL(768, 3, 6);
  if (dh == 768 && parts == 1) return T4_WIDE_CL(768);
  if (dh == 896 && parts == 3) return T4_FWD_CL(896, 3, 7);
  if (dh == 896 && parts == 1) return T4_WIDE_CL(896);
  if (dh == 1024 && parts == 3) return T4_FWD_CL(1024, 3, 8);
  if (dh == 1024 && parts == 1) return T4_WIDE_CL(1024);
#undef T4_FWD_CL
#undef T4_WIDE_CL
  return static_cast<int>(cudaErrorInvalidValue);
}

// the f32 class's operands: q * qscale, k and v [rows, cols] f32 (cols % 8
// == 0, contiguous) -> out [3 (q, k, v), 3 (hi, mid, lo), rows, cols] bf16,
// 16-byte aligned, x = hi + mid + lo (split_bf16.cuh); one launch.
extern "C" int t4_split_qkv(const float* q, const float* k, const float* v,
                            void* out, int rows, int cols, float qscale,
                            void* stream) {
  if (rows < 1 || cols < 8 || cols % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* parts = static_cast<__nv_bfloat16*>(out);
  const size_t op = 3 * static_cast<size_t>(rows) * cols;   // an operand's
  const float* in[3] = {q, k, v};
  SplitJob jobs[3];
  for (int i = 0; i < 3; ++i)
    jobs[i] = {in[i], parts + i * op, rows, cols, cols,
               aligned(in[i], 16) ? 1 : 0, i == 0 ? qscale : 1.f};
  return launch_split(3, jobs, 3, static_cast<cudaStream_t>(stream));
}
