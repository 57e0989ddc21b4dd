// Splitting f32 values into bf16 parts: the device code that gemm_sm90.cu
// (K5a's rounding pass), flash_fwd.cu (K1's operand split, and its P split
// in registers) and flash_bwd.cu (K2's operand split, and its p and ds
// split in registers) share.  Everything is in an anonymous namespace: each
// source that includes it is a library of its own.
//
// x = hi + lo (2 parts, the class 3pass):  hi = bf16(x), lo = bf16(x - hi)
//   with the subtraction flushing subnormals, as the reference's split does
//   on the TPU (gemm_pallas.py:80-83).
// x = hi + mid + lo (3 parts, six products: the classes highest and K1's
//   f32):  hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
//   rounding to nearest even and each f32 subtraction exact, subnormals
//   kept.  The three parts give x back exactly for every f32 with
//   2^-110 <= |x| < 0x1.FEp127 (the bf16 rounding of the top of that range
//   is inf): hi holds 8 bits of x's 24, mid the next 8 or fewer, and what is
//   left is at most 8 bits wide, so lo holds it exactly as long as x's
//   lowest bit is no finer than bf16's smallest subnormal, 2^-133.  Zeros
//   split into zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// a - b as the TPU (and XLA on the CPU) subtracts in the reference's 3pass
// split: subnormal inputs taken as zero, a subnormal result flushed to
// zero, both keeping their sign
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// a - b rounded to nearest, subnormals kept (exact in the three-part split)
__device__ __forceinline__ float sub_rn(float a, float b) {
  float d;
  asm("sub.rn.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 split into NP registers of two bf16 each (x0 in the low halves):
// NP 1 hi; 2 hi, lo (flushing); 3 hi, mid, lo (exact).  cvt.rn.bf16x2.f32
// rounds to nearest even and keeps subnormals.
template <int NP>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&out)[NP]) {
  static_assert(NP >= 1 && NP <= 3, "parts");
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  out[0] = bf16x2_bits(h);
  if constexpr (NP == 2) {
    const float2 f = __bfloat1622float2(h);
    out[1] = bf16x2_bits(
        __floats2bfloat162_rn(sub_ftz(x0, f.x), sub_ftz(x1, f.y)));
  } else if constexpr (NP == 3) {
    const float2 f = __bfloat1622float2(h);
    const float r0 = sub_rn(x0, f.x), r1 = sub_rn(x1, f.y);
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 g = __bfloat1622float2(m);
    out[1] = bf16x2_bits(m);
    out[2] = bf16x2_bits(
        __floats2bfloat162_rn(sub_rn(r0, g.x), sub_rn(r1, g.y)));
  }
}

// the six products of three parts, smallest first: product p multiplies
// part prod_a(p) of the left operand by part prod_b(p) of the right one
// (0 hi, 1 mid, 2 lo): lo hi, mid mid, hi lo, mid hi, hi mid, hi hi.  The
// three left out (mid lo, lo mid, lo lo) are below 2^-24 of the terms.
__host__ __device__ constexpr int prod_a(int p) {
  return p == 0 ? 2 : (p == 1 || p == 3) ? 1 : 0;
}
__host__ __device__ constexpr int prod_b(int p) {
  return p == 2 ? 2 : (p == 1 || p == 4) ? 1 : 0;
}

// ---- the split pass --------------------------------------------------------
// One job: x [rows, cols] f32, row-major and contiguous, times `scale` (an
// f32 product, exact when scale is 1) -> parts [NP, rows, ld] bf16, part p
// at out + p rows ld, zeros in columns cols..ld-1.  ld % 8 == 0.  Bound by
// bytes: a thread writes 8 outputs of one row (one 16-byte store a part), a
// block 8 RT of the job's rows x ld elements taken as one run.
constexpr int RT = 128;         // threads of a split block

struct SplitJob {
  const float* x;
  __nv_bfloat16* out;
  int rows, cols, ld, vec;      // vec: x 16-byte aligned and cols % 4 == 0
  float scale;
};

// grid (blocks over the largest job, 1, jobs): blockIdx.z picks the job,
// field by field (a reference to one job would copy all four to the stack)
template <int NP>
__global__ void __launch_bounds__(RT)
    split_kernel(SplitJob j0, SplitJob j1, SplitJob j2, SplitJob j3) {
  const int z = blockIdx.z;
#define T4_PICK(f) \
  (z == 0 ? j0.f : z == 1 ? j1.f : z == 2 ? j2.f : j3.f)
  const int ld = T4_PICK(ld);
  const size_t total = static_cast<size_t>(T4_PICK(rows)) * ld;
  const size_t e = (static_cast<size_t>(blockIdx.x) * RT + threadIdx.x) * 8;
  if (e >= total) return;
  const int row = static_cast<int>(e / ld), c0 = static_cast<int>(e % ld);
  const int cols = T4_PICK(cols);
  const float scale = T4_PICK(scale);
  const float* src = T4_PICK(x) + static_cast<size_t>(row) * cols + c0;
  float v[8];
  if (T4_PICK(vec) && c0 + 8 <= cols) {
    const float4 p = *reinterpret_cast<const float4*>(src);
    const float4 q = *reinterpret_cast<const float4*>(src + 4);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = c0 + i < cols ? src[i] : 0.f;
  }
  uint32_t w[4][NP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_pair<NP>(v[2 * i] * scale, v[2 * i + 1] * scale, w[i]);
  __nv_bfloat16* out = T4_PICK(out) + e;
#undef T4_PICK
#pragma unroll
  for (int p = 0; p < NP; ++p)
    *reinterpret_cast<uint4*>(out + p * total) =
        make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
}

// one launch of the pass over up to four jobs (n_jobs of jobs[0..3]) in NP
// parts (1 to 3); cudaGetLastError() as int
inline int launch_split(int np, const SplitJob* jobs, int n_jobs,
                        cudaStream_t stream) {
  size_t most = 0;
  for (int i = 0; i < n_jobs; ++i) {
    if (jobs[i].ld % 8 || jobs[i].ld < jobs[i].cols || jobs[i].rows < 1 ||
        reinterpret_cast<uintptr_t>(jobs[i].out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    most = std::max(most, static_cast<size_t>(jobs[i].rows) * jobs[i].ld);
  }
  const size_t blocks = (most / 8 + RT - 1) / RT;
  if (n_jobs < 1 || n_jobs > 4 || blocks > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), 1, n_jobs);
  const SplitJob& j1 = jobs[n_jobs > 1 ? 1 : 0];
  const SplitJob& j2 = jobs[n_jobs > 2 ? 2 : 0];
  const SplitJob& j3 = jobs[n_jobs > 3 ? 3 : 0];
  if (np == 1)
    split_kernel<1><<<grid, RT, 0, stream>>>(jobs[0], j1, j2, j3);
  else if (np == 2)
    split_kernel<2><<<grid, RT, 0, stream>>>(jobs[0], j1, j2, j3);
  else if (np == 3)
    split_kernel<3><<<grid, RT, 0, stream>>>(jobs[0], j1, j2, j3);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
