// The f32 dot c = a b in the order XLA's CPU backend sums it (the replay of
// ops/xla_dot.py, which states the order and picks its two parameters).
//
// c[i, j] = sum over k of a[i, k] b[k, j], a [m, k] and b [k, n] row-major
// f32.  The reduction runs in blocks of `kc` values of k, one after
// another; inside a block `nch` interleaved chains over its whole
// multiples of nch, chain t taking k0 + t, k0 + t + nch, ... as exact fused
// multiply-adds (std::fma) from +0; the chains fold in adjacent pairs,
// ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)); the block's last
// (k1 - k0) % nch products are rounded and summed one after another from
// +0, and that sum is added to the fold.
// The first block's value is the running sum, each later block's is added
// to it.  XLA's runtime flushes subnormals: the flags are set for the
// call and put back.  The loops run over j innermost, so the compiler
// vectorises across the independent output elements, never across k.
//
// Build: g++ -O2 -mfma -ffp-contract=off -shared -fPIC (ops/xla_dot.py
// does it at first use); without -ffp-contract=off the compiler may fuse
// the tail's multiply and add.

#include <cmath>
#include <cstddef>
#include <vector>
#include <xmmintrin.h>

extern "C" int t4_xla_dot(const float* a, const float* b, float* c, int m,
                          int k, int n, int kc, int nch) {
  if (m < 1 || k < 1 || n < 1 || kc < 1 || nch < 1 || nch > 8 ||
      (nch & (nch - 1)) != 0)
    return 1;
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040);          // flush to zero, denormals are zero
  std::vector<float> acc(static_cast<size_t>(nch) * n);
  for (int i = 0; i < m; ++i) {
    float* ci = c + static_cast<size_t>(i) * n;
    const float* ai = a + static_cast<size_t>(i) * k;
    for (int k0 = 0; k0 < k; k0 += kc) {
      const int k1 = k0 + kc < k ? k0 + kc : k;
      // the chains over the block's whole multiples of nch, folded
      const int kt = k1 - (k1 - k0) % nch;
      for (size_t x = 0; x < acc.size(); ++x) acc[x] = 0.f;
      for (int kk = k0; kk < kt; ++kk) {
        float* at = acc.data() + static_cast<size_t>((kk - k0) % nch) * n;
        const float av = ai[kk];
        const float* bk = b + static_cast<size_t>(kk) * n;
        for (int j = 0; j < n; ++j) at[j] = std::fma(av, bk[j], at[j]);
      }
      for (int w = 1; w < nch; w *= 2)
        for (int t = 0; t + w < nch; t += 2 * w) {
          float* lo = acc.data() + static_cast<size_t>(t) * n;
          const float* hi = acc.data() + static_cast<size_t>(t + w) * n;
          for (int j = 0; j < n; ++j) lo[j] = lo[j] + hi[j];
        }
      // the rest: its products rounded, summed one after another from +0
      // (no fused multiply-add: the build passes -ffp-contract=off), the
      // sum added to the fold
      if (kt < k1) {
        float* tail = acc.data() + (nch > 1 ? static_cast<size_t>(n) : 0);
        for (int j = 0; j < n; ++j) tail[j] = 0.f;
        for (int kk = kt; kk < k1; ++kk) {
          const float av = ai[kk];
          const float* bk = b + static_cast<size_t>(kk) * n;
          for (int j = 0; j < n; ++j) {
            const float p = av * bk[j];
            tail[j] = tail[j] + p;
          }
        }
        for (int j = 0; j < n; ++j)
          acc[j] = kt > k0 ? acc[j] + tail[j] : tail[j];
      }
      if (k0 == 0)
        for (int j = 0; j < n; ++j) ci[j] = acc[j];
      else
        for (int j = 0; j < n; ++j) ci[j] = ci[j] + acc[j];
    }
  }
  _mm_setcsr(csr);
  return 0;
}

// A row times a matrix, c [n] = a [k] b [k, n] (b row-major), in the order
// of the loop that XLA's CPU backend fuses such a dot into inside a
// program, as LLVM vectorised it (ops/xla_dot.py: fused_order states it):
// nacc interleaved accumulators of eight lanes, step i of the loop adding
// products 8 nacc i + 8 x + l into lane l of accumulator x as exact fused
// multiply-adds (k a multiple of 8 nacc); accumulator 0 starts from (+0,
// -0, ..., -0), the others from -0.  They fold as ((r1 + r0) + r2) + r3,
// the eight lanes as ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7))
// (the extract, shuffle and add of the horizontal reduction).
extern "C" int t4_xla_row(const float* a, const float* b, float* c, int k,
                          int n, int nacc) {
  if (k < 1 || n < 1 || nacc < 1 || nacc > 4 || k % (8 * nacc) != 0)
    return 1;
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040);
  for (int j = 0; j < n; ++j) {
    float r[4][8];
    for (int x = 0; x < nacc; ++x)
      for (int l = 0; l < 8; ++l) r[x][l] = (x == 0 && l == 0) ? 0.f : -0.f;
    for (int k0 = 0; k0 < k; k0 += 8 * nacc)
      for (int x = 0; x < nacc; ++x)
        for (int l = 0; l < 8; ++l) {
          const int kk = k0 + 8 * x + l;
          r[x][l] = std::fma(a[kk], b[static_cast<size_t>(kk) * n + j],
                             r[x][l]);
        }
    float f[8];
    for (int l = 0; l < 8; ++l) {
      f[l] = nacc > 1 ? r[1][l] + r[0][l] : r[0][l];
      for (int x = 2; x < nacc; ++x) f[l] = r[x][l] + f[l];
    }
    c[j] = ((f[0] + f[4]) + (f[2] + f[6])) + ((f[1] + f[5]) + (f[3] + f[7]));
  }
  _mm_setcsr(csr);
  return 0;
}
