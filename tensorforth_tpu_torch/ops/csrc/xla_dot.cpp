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
