// The Hopper machinery that gemm_sm90.cu (K5a, K6), gemm_sm90_f32.cu (K5b,
// K7), flash_bwd_fused.cu (K3), flash_fwd.cu (K1), attn_dots.cu (K8) and
// flash_bwd.cu (K2a, K2b) share: mbarriers with a trapping wait, TMA loads
// (tiles and plain bulk copies), the cluster barrier and distributed
// shared memory with the sum of a cluster's partials (the dh-split routes
// of flash_fwd.cuh, flash_bwd.cu and flash_bwd_fused.cu), wgmma's shared-memory descriptors and its operand
// forms (m64n128, m64n64 and m64n32, A from shared memory or registers,
// either operand transposed), the flash kernels' exp2, the grouped raster
// of output tiles, the predicated epilogue store, and on the host the
// tensor maps and the launches, plain and in clusters.  Everything is in
// an anonymous namespace: each source that includes it is a library of its
// own.
//
// Tiles are 128 x 256 (or 128 x 128): warpgroups 0 and 1 are consumers
// that own 64 rows each and hold WN m64n128 accumulators.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ALIGN = 1024;           // the 128-byte swizzle repeats every
                                      // 8 rows: tiles start 1024-aligned
constexpr int GROUP_M = 8;            // tile rows per raster group
constexpr int SMEM_LIMIT = 232448;    // a block's dynamic shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first ALIGN-aligned shared address of the dynamic shared memory
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (smem_u32(smem) + ALIGN - 1) & ~(ALIGN - 1);
}

// ---- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`.  A
// wait that outlasts any real one by orders of magnitude traps: a barrier
// that can never complete faults the launch instead of hanging the card.
// CLUSTER: the arrivals came from other CTAs of the cluster (acquire at
// cluster scope).
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    if constexpr (CLUSTER)
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    if (spin == (1u << 22)) __trap();
  }
}

// shared-memory writes of the generic proxy (st.shared) made visible to the
// async proxy (wgmma's operand reads), for the thread that wrote them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- TMA -------------------------------------------------------------------
// one box of `map` at (c0 inner, c1 outer) into shared memory at dst; the
// bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory at src (16-byte
// aligned) into shared memory at dst; the bytes complete a transaction on
// `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the `threads` threads (whole warps) that name barrier `id` (1..15; 0 is
// __syncthreads') wait for each other
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- clusters --------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the cluster barrier: every thread of every CTA of the cluster arrives
// (release: its earlier writes are seen by the others) before any of them
// passes (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// the shared::cluster address of shared address `addr` in CTA `rank` of
// the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// four floats to a shared::cluster address in another CTA of the cluster,
// their 16 bytes completing a transaction on that CTA's mbarrier `bar` (a
// shared::cluster address of the same CTA); no acknowledgement is waited for
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b,
                                          float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b,
                                           float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// one arrival on an mbarrier of another CTA of the cluster (a
// shared::cluster address), releasing this thread's earlier writes to the
// cluster
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}

// a cluster's exchange of a thread's N partial floats (N % 4 == 0; the
// dh-split routes of flash_fwd.cuh, flash_bwd.cu and flash_bwd_fused.cu,
// THREADS threads a CTA): to its twin's slot in another CTA (N / 4 float4
// from `at`, a shared::cluster address, THREADS * 16 bytes apart),
// completing their bytes on that CTA's barrier at `bar`
template <int THREADS, int N>
__device__ __forceinline__ void push(const float (&x)[N], uint32_t at,
                                     uint32_t bar) {
  static_assert(N % 4 == 0, "whole float4");
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    st_async4(at + j * THREADS * 16, x[4 * j], x[4 * j + 1], x[4 * j + 2],
              x[4 * j + 3], bar);
}

// ... and the twin's partial, from this thread's own slot at `at`, added
template <int THREADS, int N>
__device__ __forceinline__ void add_peer(float (&x)[N], uint32_t at) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 y = ld_shared4(at + j * THREADS * 16);
    x[4 * j] += y.x;
    x[4 * j + 1] += y.y;
    x[4 * j + 2] += y.z;
    x[4 * j + 3] += y.w;
  }
}

// The sum of a pair's partials on the dh-256 routes of flash_bwd.cu (K2a,
// K2b) and flash_bwd_fused.cu (K3's f32 class): two CTAs of THREADS
// threads, each thread holding its CTA's partial sums over the CTA's 128
// columns of dh, each leaving with x0 + x1, THE SAME BITS IN BOTH (an f32
// sum of two terms is the same in either order; ops/attn.py: cluster_sum).
// A message is each thread's floats, stored into its twin's place in the
// peer's slot through distributed shared memory (st.async), the bytes
// completing a transaction on the peer's `full` barrier, so no store waits
// for an acknowledgement; each thread's own arrival on `full` expects the
// bytes its twin sends.  A CTA's slot holds one message (THREADS x the
// message's floats), so the slot's reader, once it has added a message,
// arrives on the writer's `empty` barrier, which guards the writer's next
// message.  Every wait is a local mbarrier wait that traps as the others
// do.  The rank is read again where it is needed (a special register), so
// that no register holds it.  Clusters of 3 to 8 sum in Xrs below.
template <int THREADS>
struct Xch {
  // the backward's message: 16 floats of s2, then (here) 16 of dp
  static constexpr uint32_t DP_AT = 4 * THREADS * 16;
  static constexpr int NBAR = 2;   // full, then empty
  uint32_t slot;   // this thread's place in its own slot
  uint32_t full;   // this CTA's barriers, from full on

  __device__ uint32_t empty() const { return full + 8; }
  // the other CTA of the pair
  __device__ int pair() const {
    return static_cast<int>(cluster_ctarank()) ^ 1;
  }
  // thread 0, before the cluster barrier that precedes any message
  __device__ void init() const {
    mbar_init(full, THREADS);
    mbar_init(empty(), THREADS);
  }
  // before tile it's message: the pair has read the last one
  __device__ void wait_free(int it) const {
    if (it > 0) mbar_wait<true>(empty(), (it - 1) & 1);
  }
  // x into the twin's place of the pair's slot, `off` bytes on
  template <int N>
  __device__ void send(const float (&x)[N], uint32_t off) const {
    push<THREADS>(x, cluster_addr(slot + off, pair()),
                  cluster_addr(full, pair()));
  }
  // wait for tile it's message, `bytes` from the twin
  __device__ void receive(uint32_t bytes, int it) const {
    mbar_expect_tx(full, bytes);
    mbar_wait<true>(full, it & 1);
  }
  // the message's floats at `off`, added to x
  template <int N>
  __device__ void add(float (&x)[N], uint32_t off) const {
    add_peer<THREADS>(x, slot + off);
  }
  // the message is read: the slot takes the next one
  __device__ void read() const {
    mbar_arrive_remote(cluster_addr(empty(), pair()));
  }
  // after the last of n tiles: the pair has read this CTA's messages for
  // the last time, so it accesses this CTA's shared memory no more
  __device__ void drain(int n) const {
    mbar_wait<true>(empty(), (n - 1) & 1);
  }
};

// A pair's tile of partial s2 and dp, 16 floats each a thread; each
// thread's floats at the slot's start (s2) and X::DP_AT bytes on (dp).
// dp leaves for the pair while s2's products run, once the pair has read
// its slot's last message
template <class X>
__device__ __forceinline__ void xch_send_dp(const X& x, const float (&dp)[16],
                                            int it) {
  x.wait_free(it);
  x.send(dp, X::DP_AT);
}

// then s2's, and the twin's two partials are added: both sums are over all
// of dh, the same bits in both CTAs.  READ false leaves read() to the
// caller, which keeps the slot for its own use until then (K3 writes ds^T's
// parts there)
template <bool READ = true, class X>
__device__ __forceinline__ void xch_sum_scores(const X& x, float (&s)[16],
                                               float (&dp)[16], int it) {
  x.send(s, 0);
  x.receive(32 * 4, it);
  x.add(s, 0);
  x.add(dp, X::DP_AT);
  if (READ) x.read();
}

// ---- the clusters' balanced exchange (Xrs) ----------------------------------
// Every route at dh 384 to 1024 on a cluster (CL 3 to 8) adds a tile's
// partial scores in two rounds, a reduce-scatter and an all-gather:
// flash_bwd.cu's K2a and K2b and flash_bwd_fused.cu's K3 their s2 and dp,
// flash_fwd.cuh's K1 (the f32 class) its s2.  A thread's 32 floats are 8
// quads (s2's 4, then dp's 4; K1: s2's 8).  Quad q belongs to CTA q mod CL
// where CL divides 8 (4, 8); otherwise quad q of the threads of warp w of a
// warpgroup belongs to CTA (q + w) mod CL: each CTA owns 8 / CL of every
// thread's quads on the whole, the warps staggered so that no CTA owns
// more than ceil(8 / CL) of a thread's, and every CTA some of each.
//   round 1: a thread sends each quad it does not own to its owner
//     (K2, K3: dp's while s2's products run; K1's all once its score
//     products are done), into the owner's pool: its slot read
//     as warp-planes (one quad for each lane of a warp), warp w's block
//     holding its owned quads' CL - 1 partials by source rank.  The owner
//     adds the CL partials of each quad in cluster_sum's order, ((x0 + x1)
//     + (x2 + x3)) + ((x4 + x5) + (x6 + x7)), absent ranks dropped: the
//     bits of ops/attn.py's cluster_sum, which the plain versions keep.
//   round 2: the owner sends each summed quad to every peer, at the quad's
//     own place (plane q of the thread), so every CTA leaves with the 32
//     sums.
// Every store is one st.async of 16 bytes and every choice a constant of a
// copy compiled for each rank (T4_XRS) and, where the owners are
// staggered, each warp of a warpgroup (one copy for all at CL 4 and 8,
// which measured faster there); a thread sends 5 to 7 quads in round 1
// and 6 to 12 in round 2 (at CL 7 the warp that owns two quads sends them
// to six peers).  Each round's
// bytes complete a transaction on the receiver's barrier of that round
// (got1, got2; one phase a tile, every thread expecting its twins' bytes).
//   SLOTS 2 (the hybrid class, which has the shared memory): round 1 lands
// in the first slot, round 2 in the second, and no sender ever waits: a
// thread's round-1 quad of tile it + 1 follows its twin's round-2 quads of
// tile it, which the twin could only form after reading what this thread
// sent it in tile it, and this thread sent round 1 of tile it only after
// reading its round-2 slot of tile it - 1.
//   SLOTS 1 (the f32 class: K2's 230,968 of 232,448 bytes, K1's 230,456,
// K3's 230,968): both rounds share the slot, so a round-2 sender waits for
// its targets' round-1 reads (free2) and a round-1 sender for their last
// round-2 reads (free1, from tile 1 on); a reader signals them a warp at a
// time, lanes 0 .. CL - 2 one arrival each on a peer's barrier, after it
// has used what it read (read(): K3 keeps ds^T's parts in the slot once
// round 2 is read, so it calls read() after its dq products, the last
// readers of ds^T).  The last tile's round-2 reads are not signalled, and
// every other message is awaited by its reader, so no CTA touches
// another's shared memory after its loop: no drain.
template <int CL, int THREADS, int RK, int SLOTS>
struct Xrs {
  static_assert(CL >= 3 && CL <= 8, "a cluster of 3 to 8 CTAs");
  static_assert(RK >= 0 && RK < CL, "a copy for each rank");
  static_assert(SLOTS == 1 || SLOTS == 2, "one or two slots");
  static_assert(THREADS % 128 == 0, "whole warpgroups");
  static constexpr int NQ = 8;     // a thread's quads: s2's 4, then dp's 4
  static constexpr int NW = 4;     // the warps of a warpgroup
  static constexpr uint32_t PLANE = THREADS * 16;   // one quad a thread
  static constexpr uint32_t WPLANE = 32 * 16;       // one quad a lane
  static constexpr uint32_t SLOT_BYTES = THREADS * NQ * 16;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NBAR = SLOTS == 1 ? 4 : 2;   // got1, got2, free1, 2
  // CL divides the 8 quads (4, 8): every warp's quads have the same owners
  static constexpr bool UNIFORM = NQ % CL == 0;
  uint32_t slot;   // this thread's place in its own (first) slot
  uint32_t bar;    // this CTA's barriers: got1, got2 (, free1, free2)

  // ---- the schedule (w: a warp's index in its warpgroup)
  // the owner of quad q of warp w's threads: staggered by warp unless CL
  // divides the quads
  __host__ __device__ static constexpr int owner(int w, int q) {
    return (q + (UNIFORM ? 0 : w)) % CL;
  }
  // the quads of warp w's threads that CTA j owns, and those before q
  __host__ __device__ static constexpr int owns(int j, int w, int q = NQ) {
    int n = 0;
    for (int p = 0; p < q; ++p) n += owner(w, p) == j ? 1 : 0;
    return n;
  }
  // CTA j's round-1 pool, in warp-planes (a quad for each lane of a warp):
  // warp w's block of its owned quads' CL - 1 partials from warp-plane
  // first(j, w) on (warpgroup 1's blocks after all of warpgroup 0's)
  __host__ __device__ static constexpr int first(int j, int w) {
    int n = 0;
    for (int v = 0; v < w; ++v) n += (CL - 1) * owns(j, v);
    return n;
  }
  __host__ __device__ static constexpr int span(int j) {
    return first(j, NW);
  }
  // the warp-plane of source s's partial of quad q (owned by j) of warp
  // w, from the warp's block on
  __host__ __device__ static constexpr int wplane(int j, int w, int q,
                                                  int s) {
    return owns(j, w, q) * (CL - 1) + (s < j ? s : s - 1);
  }
  static_assert(WARPS / NW * span(0) <= NQ * THREADS / 32 &&
                    WARPS / NW * span(CL - 1) <= NQ * THREADS / 32 &&
                    WARPS / NW * span(CL / 2) <= NQ * THREADS / 32,
                "a round-1 pool fits its slot");
  // element i of quad Q: s2's floats 4 Q .. 4 Q + 3, or dp's (N 16); of
  // the one array s of 32, which the caller passes as dp too (N 32, K1)
  template <int Q, int N>
  __device__ static float at(const float (&s)[N], const float (&dp)[N],
                             int i) {
    static_assert(N == 16 || N == 32, "s2 and dp's 16, or s2's 32");
    if constexpr (N == 32 || Q < 4)
      return s[4 * Q + i];
    else
      return dp[4 * Q - 16 + i];
  }
  template <int Q, int N>
  __device__ static void put(float (&s)[N], float (&dp)[N], float4 v) {
    if constexpr (N == 32 || Q < 4) {
      s[4 * Q] = v.x, s[4 * Q + 1] = v.y, s[4 * Q + 2] = v.z,
      s[4 * Q + 3] = v.w;
    } else {
      dp[4 * Q - 16] = v.x, dp[4 * Q - 15] = v.y, dp[4 * Q - 14] = v.z,
      dp[4 * Q - 13] = v.w;
    }
  }

  __device__ uint32_t got(int k) const { return bar + 8 * (k - 1); }
  __device__ uint32_t freed(int k) const { return bar + 8 * (k + 1); }
  // this thread's place of warp-plane p of its warp's block in CTA j's
  // pool (the same offset in every CTA; g: its warpgroup, w: its warp in
  // it, W: the copy's warp, w's owners)
  template <int W>
  __device__ uint32_t pool(int j, int p, int g, int w) const {
    const int block = UNIFORM ? w * (CL - 1) * owns(j, 0) : first(j, W);
    return slot + static_cast<uint32_t>((g * span(j) + block + p - g * NW -
                                         w) *
                                        static_cast<int>(WPLANE));
  }

  // thread 0, before the cluster barrier that precedes any message
  __device__ void init() const {
    mbar_init(got(1), THREADS);
    mbar_init(got(2), THREADS);
    if constexpr (SLOTS == 1) {
      mbar_init(freed(1), WARPS * (CL - 1));
      mbar_init(freed(2), WARPS * (CL - 1));
    }
  }
  // round 1: quads Q .. Q1 - 1 of warp W's threads to their owners
  template <int W, int Q, int Q1, int N>
  __device__ void send1(const float (&s)[N], const float (&dp)[N], int g,
                        int w) const {
    if constexpr (Q < Q1) {
      constexpr int j = owner(W, Q);
      if constexpr (j != RK)
        st_async4(cluster_addr(pool<W>(j, wplane(j, W, Q, RK), g, w), j),
                  at<Q>(s, dp, 0), at<Q>(s, dp, 1), at<Q>(s, dp, 2),
                  at<Q>(s, dp, 3), cluster_addr(got(1), j));
      send1<W, Q + 1, Q1>(s, dp, g, w);
    }
  }
  // the owner's sums of its quads from Q on: the CL partials of each, in
  // cluster_sum's order
  template <int W, int Q = 0, int N>
  __device__ void reduce(float (&s)[N], float (&dp)[N], int g,
                         int w) const {
    if constexpr (Q < NQ) {
      if constexpr (owner(W, Q) == RK) {
        float x[CL][4];
        gather<W, Q>(x, s, dp, g, w);
        float4 v;
        v.x = tree<0, 8>(x, 0);
        v.y = tree<0, 8>(x, 1);
        v.z = tree<0, 8>(x, 2);
        v.w = tree<0, 8>(x, 3);
        put<Q>(s, dp, v);
      }
      reduce<W, Q + 1>(s, dp, g, w);
    }
  }
  template <int W, int Q, int R = 0, int N>
  __device__ void gather(float (&x)[CL][4], const float (&s)[N],
                         const float (&dp)[N], int g, int w) const {
    if constexpr (R < CL) {
      if constexpr (R == RK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[R][i] = at<Q>(s, dp, i);
      } else {
        const float4 v =
            ld_shared4(pool<W>(RK, wplane(RK, W, Q, R), g, w));
        x[R][0] = v.x;
        x[R][1] = v.y;
        x[R][2] = v.z;
        x[R][3] = v.w;
      }
      gather<W, Q, R + 1>(x, s, dp, g, w);
    }
  }
  // round 2: each owned quad from Q on to every peer, at its own place
  template <int W, int Q = 0, int N>
  __device__ void send2(const float (&s)[N], const float (&dp)[N],
                        uint32_t off) const {
    if constexpr (Q < NQ) {
      if constexpr (owner(W, Q) == RK) {
#pragma unroll
        for (int r = 0; r < CL; ++r)
          if (r != RK)
            st_async4(cluster_addr(slot + off + Q * PLANE, r),
                      at<Q>(s, dp, 0), at<Q>(s, dp, 1), at<Q>(s, dp, 2),
                      at<Q>(s, dp, 3), cluster_addr(got(2), r));
      }
      send2<W, Q + 1>(s, dp, off);
    }
  }
  // round 2's sums of the quads it does not own, from Q on
  template <int W, int Q = 0, int N>
  __device__ void gather2(float (&s)[N], float (&dp)[N],
                          uint32_t off) const {
    if constexpr (Q < NQ) {
      if constexpr (owner(W, Q) != RK)
        put<Q>(s, dp, ld_shared4(slot + off + Q * PLANE));
      gather2<W, Q + 1>(s, dp, off);
    }
  }

  // tile it's dp quads leave for their owners (once their slots are
  // free), while s2's products run
  template <int W>
  __device__ void send_dp_w(const float (&dp)[16], int it, int g,
                            int w) const {
    if constexpr (SLOTS == 1)
      if (it > 0) mbar_wait<true>(freed(1), (it - 1) & 1);
    send1<W, 4, NQ>(dp, dp, g, w);
  }
  // then s2's (quads 0 .. Q1 - 1: K1 sends all 8 here); the owners' sums;
  // the all-gather: s and dp leave with the sums over all of dh, the same
  // bits in every CTA
  template <int W, int Q1 = 4, int N>
  __device__ void sum_w(float (&s)[N], float (&dp)[N], int it, int g,
                        int w) const {
    send1<W, 0, Q1>(s, dp, g, w);
    mbar_expect_tx(got(1), (CL - 1) * owns(RK, W) * 16);
    mbar_wait<true>(got(1), it & 1);
    reduce<W>(s, dp, g, w);
    if constexpr (SLOTS == 1) {
      signal(freed(2));                       // its pool places are read
      mbar_wait<true>(freed(2), it & 1);      // and so are its targets'
    }
    constexpr uint32_t OFF2 = SLOTS == 2 ? SLOT_BYTES : 0;
    send2<W>(s, dp, OFF2);
    mbar_expect_tx(got(2), (NQ - owns(RK, W)) * 16);
    mbar_wait<true>(got(2), it & 1);
    gather2<W>(s, dp, OFF2);
  }
  // a copy for each warp of a warpgroup where its warp picks its quads'
  // owners, one for all where CL divides the quads
  __device__ void send_dp(const float (&dp)[16], int it) const {
    const int w = static_cast<int>(threadIdx.x / 32) % NW;
    const int g = static_cast<int>(threadIdx.x / 128);
    if constexpr (UNIFORM) send_dp_w<0>(dp, it, g, w);
    else if (w == 0) send_dp_w<0>(dp, it, g, w);
    else if (w == 1) send_dp_w<1>(dp, it, g, w);
    else if (w == 2) send_dp_w<2>(dp, it, g, w);
    else send_dp_w<3>(dp, it, g, w);
  }
  __device__ void sum(float (&s)[16], float (&dp)[16], int it) const {
    const int w = static_cast<int>(threadIdx.x / 32) % NW;
    const int g = static_cast<int>(threadIdx.x / 128);
    if constexpr (UNIFORM) sum_w<0>(s, dp, it, g, w);
    else if (w == 0) sum_w<0>(s, dp, it, g, w);
    else if (w == 1) sum_w<1>(s, dp, it, g, w);
    else if (w == 2) sum_w<2>(s, dp, it, g, w);
    else sum_w<3>(s, dp, it, g, w);
  }
  // K1: tile it of n_it, a thread's 32 partial floats of s2, all 8 quads
  // to their owners once the slots are free, summed, gathered, and the
  // round-2 places read at once (s holds the sums)
  template <int W>
  __device__ void sum_s2_w(float (&s)[32], int it, int n_it, int g,
                           int w) const {
    if constexpr (SLOTS == 1)
      if (it > 0) mbar_wait<true>(freed(1), (it - 1) & 1);
    sum_w<W, NQ>(s, s, it, g, w);
    read(it, n_it);
  }
  __device__ void sum(float (&s)[32], int it, int n_it) const {
    const int w = static_cast<int>(threadIdx.x / 32) % NW;
    const int g = static_cast<int>(threadIdx.x / 128);
    if constexpr (UNIFORM) sum_s2_w<0>(s, it, n_it, g, w);
    else if (w == 0) sum_s2_w<0>(s, it, n_it, g, w);
    else if (w == 1) sum_s2_w<1>(s, it, n_it, g, w);
    else if (w == 2) sum_s2_w<2>(s, it, n_it, g, w);
    else sum_s2_w<3>(s, it, n_it, g, w);
  }
  // after the caller has used tile it's sums: its round-2 places are read
  // (one slot: the peers' next round 1 may write; the last tile's go
  // unsignalled, as nothing follows them)
  __device__ void read(int it, int n_it) const {
    if constexpr (SLOTS == 1)
      if (it + 1 < n_it) signal(freed(1));
  }
  // this warp is done with what it read: one arrival on barrier `b` of
  // each peer, lane i on the i-th
  __device__ void signal(uint32_t b) const {
    __syncwarp();
    const int lane = static_cast<int>(threadIdx.x % 32);
    if (lane < CL - 1)
      mbar_arrive_remote(cluster_addr(b, lane < RK ? lane : lane + 1));
  }
  // the sum of x[B .. B + H - 1][i] (ranks below CL) as cluster_sum forms it
  template <int B, int H>
  __device__ static float tree(const float (&x)[CL][4], int i) {
    if constexpr (H == 1) {
      return x[B < CL ? B : 0][i];
    } else if constexpr (B + H / 2 < CL) {
      return tree<B, H / 2>(x, i) + tree<B + H / 2, H / 2>(x, i);
    } else {
      return tree<B, H / 2>(x, i);
    }
  }
};

// `stmt` with `xr` the CTA's Xrs<CL, THREADS, rank, SLOTS> on (slot, bar):
// a copy compiled for each rank, picked by the CTA's rank
#define T4_XRS_AT(R, CL, THREADS, SLOTS, SLOT, BAR, stmt)                 \
  if constexpr ((R) < (CL)) {                                             \
    if (t4_rank == (R)) {                                                 \
      const Xrs<(CL), (THREADS), ((R) < (CL) ? (R) : 0), (SLOTS)> xr{     \
          SLOT, BAR};                                                     \
      stmt;                                                               \
    }                                                                     \
  }
#define T4_XRS(CL, THREADS, SLOTS, SLOT, BAR, stmt)                       \
  {                                                                       \
    const int t4_rank = static_cast<int>(cluster_ctarank());              \
    T4_XRS_AT(0, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
    T4_XRS_AT(1, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
    T4_XRS_AT(2, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
    T4_XRS_AT(3, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
    T4_XRS_AT(4, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
    T4_XRS_AT(5, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
    T4_XRS_AT(6, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
    T4_XRS_AT(7, CL, THREADS, SLOTS, SLOT, BAR, stmt)                     \
  }

// ---- wgmma -----------------------------------------------------------------
// shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// A, K-major: rows of 128 bytes, 8-row groups 1024 bytes apart (the
// leading offset is not used by a swizzled K-major operand)
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// B, MN-major, in boxes of 64 columns of N (one 128-byte row of bf16) by
// the slab's rows of K: the next 64 columns are the next box, `box` bytes
// on (leading offset), the next 8 rows of K 1024 bytes on (stride offset)
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, uint32_t box) {
  return sw128_desc(addr, box, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (wgmma's results are final only after a wait)
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 64 f32 accumulator registers of an m64n128 product, as asm operands
// %0..%63
#define T4_ACC64(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define T4_D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                                 \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                                 \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                                 \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                                 \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// the 32 f32 accumulator registers of an m64n64 product, as asm operands
// %0..%31
#define T4_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define T4_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// the 16 f32 accumulator registers of an m64n32 product, as asm operands
// %0..%15
#define T4_ACC16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define T4_D16                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15}"

// d[64 x 32] (+)= A[64 x 16] B[16 x 32]: wgmma_64's operand forms at N 32
template <int TA, int TB>
__device__ __forceinline__ void wgmma_32(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " T4_D16
      ", %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : T4_ACC16(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 in, f32 sums, both from
// shared memory.  TA 0: A K-major (desc_a); 1: A MN-major, read transposed
// (desc_b's form).  TB likewise for B: 0 K-major (rows of N, desc_a's
// form), 1 MN-major (rows of K, desc_b).  scale_d 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T4_D32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : T4_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 sums; both from
// shared memory, B transposed (MN-major).  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " T4_D64
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : T4_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same product with A from registers: each warp w of the warpgroup
// holds rows 16w..16w+15 as the m16k16 fragment of mma.sync (g = lane / 4,
// t = lane % 4; a0 row g, columns 2t, 2t+1; a1 row g+8; a2 row g, columns
// 2t+8, 2t+9; a3 row g+8, columns 2t+8, 2t+9; the lower column in the low
// half).  The registers are read asynchronously: they must not change
// before a wgmma_wait says that the product is done.
__device__ __forceinline__ void wgmma_128_rs(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " T4_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : T4_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: wgmma_128_rs's forms at N 64 (A
// from registers as there, B MN-major from shared memory)
__device__ __forceinline__ void wgmma_64_rs(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T4_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : T4_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// 2^x (ex2.approx: 2 ulp, subnormal results kept)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to nearest even into one register of two bf16,
// `lo` in the low half (cvt.rn.bf16x2.f32: no flush of subnormals)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- tiles -----------------------------------------------------------------
// this block's output tile origin: GROUP_M tile rows walk the tile columns
// together, so that a wave's A and B panels stay in the 50 MB L2
template <int BM, int BN>
__device__ __forceinline__ void tile_origin(int& m0, int& n0) {
  const int tiles_m = gridDim.y, tiles_n = gridDim.x;
  const int id = blockIdx.y * tiles_n + blockIdx.x;
  const int first = id / (GROUP_M * tiles_n) * GROUP_M;
  const int rows_in_group = min(tiles_m - first, GROUP_M);
  const int local = id % (GROUP_M * tiles_n);
  m0 = (first + local % rows_in_group) * BM;
  n0 = local / rows_in_group * BN;
}

// the flush of one consumer warpgroup's rows row0..row0+63: scale, then a
// predicated store.  Fragment layout of m64nNk16: warp w holds rows
// 16w..16w+15; lane l, rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1
// of each 8-column block j.  vec_c: C 8-byte aligned and ldc even.
template <int WN>
__device__ __forceinline__ void store_tile(float (&acc)[WN][64], float* C,
                                           int row0, int n0, int m, int n,
                                           int ldc, float scale, int vec_c) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = row0 + warp * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < WN; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + h * 128 + j * 8 + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= m || col >= n) continue;
        const float v0 = acc[h][4 * j + 2 * i] * scale;
        const float v1 = acc[h][4 * j + 2 * i + 1] * scale;
        float* p = C + static_cast<size_t>(row) * ldc + col;
        if (vec_c && col + 1 < n) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < n) p[1] = v1;
        }
      }
    }
}

// ---- host side -------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: taken through the runtime's
// entry-point query, so the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// map of a [rows, cols] row-major matrix of bf16 (f32 when `f32`) with a
// row pitch of ld elements, in boxes of [box_c x box_r] with the 128-byte
// swizzle (box_c elements must make 128 bytes); reads outside rows x cols
// give zeros
bool make_map(CUtensorMap* map, EncodeTiled fn, const void* p, int rows,
              int cols, int ld, int box_c, int box_r, bool f32 = false) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(ld) * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(p), dims, pitch, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// set the kernel's dynamic shared memory and launch it on `grid` x
// `threads`; cudaGetLastError() as int
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the same launch in clusters of `cluster` CTAs along x (grid.x a multiple
// of it; 1 is the plain launch); the launch's own error, else
// cudaGetLastError(), as int
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int cluster,
                   int threads, int smem, cudaStream_t stream,
                   Args... args) {
  if (cluster == 1)
    return launch(kernel, grid, threads, smem, stream, args...);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the most clusters of `cluster` CTAs of `threads` threads and `smem` bytes
// of dynamic shared memory each that the card runs at once, into *n; the
// query's cudaError_t as int
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int cluster, int threads,
                 int smem, int* n) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, kernel, &cfg));
}

}  // namespace
