// A host simulation of the clusters' balanced exchange (Xrs in
// tensorforth_tpu_torch/ops/csrc/sm90_gemm.cuh), compiled by g++ from the
// kernel's own source: tests/test_torch_bwd_xrs.py cuts the struct out of
// the header into xrs_body.h and builds this file against it.  Its one
// argument names the user whose calls it makes:
//   k2     K2a and K2b: dp's quads, then s2's and the sums, then read()
//          once the sums are used (one slot and two);
//   k1     K1: a thread's 32 floats of s2, all 8 quads in one call;
//   k3     K3: as k2, then ds^T's parts written where the class keeps
//          them (one slot: in the slot, once every thread of the CTA has
//          read round 2; two: a place of their own), read back by other
//          threads, and only then read() (one slot: the deferred
//          free-arrival);
//   k3-early  k3 with one slot and read() before ds^T is written: the
//          peers' next round 1 lands where ds^T goes, and ds^T over their
//          partials corrupts the sums (rank 0 is held back before its
//          ds^T stores: in k3 for 20 ms, in which no peer may send; here
//          until every peer's next round 1 to it has landed).
//
// Each CTA of a cluster of 3 to 8 is 256 std::threads (the kernel's two
// warpgroups, each thread with its own places in the slots), its shared
// memory an array.  An mbarrier counts pending arrivals and transaction
// bytes, and its phase completes when both reach zero, as the hardware's
// does; a wait for parity p returns once the phase of that parity has
// completed.  st.async stores 16 bytes and completes them on the target's
// barrier (a place not 16-byte aligned aborts); a remote
// arrival is one arrival; __syncwarp holds the warp's 32 threads until all
// have reached it (the reads a lane signals for are the whole warp's).
// Over 4 tiles of random partials every rank's 32 floats must come back as
// cluster_sum's tree of the cluster's partials, bit for bit, and (k3)
// every ds^T value read back as written.  A wait that never completes
// aborts.  Prints one line a case; exits 1 on any mismatch (k3-early: on
// none).
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline

struct float4 {
  float x, y, z, w;
};
struct Dim {
  unsigned x;
};
static thread_local Dim threadIdx{0};
static thread_local int my_rank = 0;

// a CTA's shared memory: the slots from 0 (k3 with two slots: ds^T's home
// after them), the barriers from BAR0 on, 8 bytes apart; a cluster address
// is rank << 20 | offset
static unsigned char smem[8][1 << 18];
static const uint32_t BAR0 = 1 << 17;
struct Bar {
  long tx = 0;
  int pending = 0, count = 0, phase = 0;
};
static Bar bars[8][16];
static std::mutex gm;   // every barrier operation, one at a time

static uint32_t cluster_addr(uint32_t a, uint32_t r) {
  return (r << 20) | (a & 0xFFFFF);
}
static float* fp(uint32_t a) {
  return reinterpret_cast<float*>(&smem[a >> 20][a & 0xFFFFF]);
}
static Bar& B(uint32_t a) {
  return bars[a >> 20][((a & 0xFFFFF) - BAR0) / 8];
}
// a phase completes when every arrival came and every expected byte landed
static void settle(Bar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.pending = b.count;
    ++b.phase;
  }
}
static void tx_bytes(uint32_t bar, long n) {
  std::lock_guard<std::mutex> l(gm);
  B(bar).tx -= n;
  settle(B(bar));
}
static void st_async4(uint32_t a, float x, float y, float z, float w,
                      uint32_t bar) {
  if (a % 16) abort();
  float* p = fp(a);
  p[0] = x, p[1] = y, p[2] = z, p[3] = w;
  tx_bytes(bar, 16);
}
static float4 ld_shared4(uint32_t a) {
  const float* p = fp(cluster_addr(a, my_rank));
  return {p[0], p[1], p[2], p[3]};
}
static void mbar_init(uint32_t bar, int count) {
  Bar& b = B(cluster_addr(bar, my_rank));
  b = Bar{0, count, count, 0};
}
static void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> l(gm);
  Bar& b = B(cluster_addr(bar, my_rank));
  b.tx += bytes;
  --b.pending;
  settle(b);
}
static void mbar_arrive_remote(uint32_t bar) {
  std::lock_guard<std::mutex> l(gm);
  --B(bar).pending;
  settle(B(bar));
}
template <bool CLUSTER = false>
static void mbar_wait(uint32_t bar, uint32_t parity) {
  const Bar& b = B(cluster_addr(bar, my_rank));
  const auto until =
      std::chrono::steady_clock::now() + std::chrono::seconds(100);
  for (long spin = 0;; ++spin) {
    {
      std::lock_guard<std::mutex> l(gm);
      if ((b.phase & 1) != static_cast<int>(parity)) return;
    }
    if (std::chrono::steady_clock::now() > until) {
      printf("a wait never completed: rank %d barrier %u\n", my_rank, bar);
      abort();
    }
    std::this_thread::yield();
  }
}
// a warp's barrier: every lane of the warp waits for the rest
struct Warp {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0, gen = 0;
};
static Warp warps[8][8], ctas[8];
static void sync_of(Warp& w, int n) {
  std::unique_lock<std::mutex> l(w.m);
  const int gen = w.gen;
  if (++w.arrived == n) {
    w.arrived = 0;
    ++w.gen;
    w.cv.notify_all();
  } else {
    w.cv.wait(l, [&] { return w.gen != gen; });
  }
}
static void __syncwarp() { sync_of(warps[my_rank][threadIdx.x / 32], 32); }

#include "xrs_body.h"

static float tree_ref(const float* x, int cl, int b, int h) {
  if (h == 1) return x[b];
  const float lo = tree_ref(x, cl, b, h / 2);
  return b + h / 2 < cl ? lo + tree_ref(x, cl, b + h / 2, h / 2) : lo;
}

constexpr int T = 256, TILES = 4;
// K3's ds^T: three parts of [64 x 64] bf16, 24 floats a thread
constexpr int DS_FLOATS = 24;
enum Mode { K2, K1, K3, K3_EARLY };
static int ds_bad = 0;   // ds^T values that came back other than written
static std::mutex ds_m;

static float ds_value(int it, int r, int t, int f) {
  return static_cast<float>(((it * 8 + r) * T + t) * DS_FLOATS + f);
}

// K3 after the sums: every thread has read round 2 (the CTA's barrier),
// then its ds^T values where the class keeps them, the CTA's barrier, and
// another thread's values read back; rank 0 is held back first, for 20 ms,
// or (landed > 0) until that many bytes of the next tile's round 1 have
// landed on its barrier (none of its threads expects them yet)
template <int SLOTS>
void ds_round_trip(int it, int r, int t, int slot_bytes, long landed) {
  sync_of(ctas[r], T);
  if (r == 0 && landed == 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  if (r == 0 && landed > 0 && it + 1 < TILES) {
    const Bar& got1 = B(cluster_addr(BAR0, 0));
    for (;;) {
      {
        std::lock_guard<std::mutex> l(gm);
        if (-got1.tx >= landed) break;
      }
      std::this_thread::yield();
    }
  }
  const uint32_t home = SLOTS == 1 ? 0 : 2 * slot_bytes;
  float* mine = fp(cluster_addr(home + t * DS_FLOATS * 4, r));
  for (int f = 0; f < DS_FLOATS; ++f) mine[f] = ds_value(it, r, t, f);
  sync_of(ctas[r], T);
  const int u = (t + 37) % T;
  const float* theirs = fp(cluster_addr(home + u * DS_FLOATS * 4, r));
  int bad = 0;
  for (int f = 0; f < DS_FLOATS; ++f)
    bad += theirs[f] != ds_value(it, r, u, f);
  sync_of(ctas[r], T);
  if (bad) {
    std::lock_guard<std::mutex> l(ds_m);
    ds_bad += bad;
  }
}

// thread t of CTA r: each tile, its partial through the exchange, as its
// kernel calls it (k2, k3: dp's floats first, then the sum, then the read;
// k1: the 32 floats of s2 in one call)
template <int CL, int SLOTS, int R = 0>
void run_thread(Mode mode, int r, int t, const float* parts, float* out) {
  if constexpr (R < CL) {
    if (r == R) {
      using X = Xrs<CL, T, R, SLOTS>;
      const X xr{static_cast<uint32_t>(t * 16), BAR0};
      float s[16], dp[16], x[32];
      for (int it = 0; it < TILES; ++it) {
        const float* in = parts + ((it * CL + R) * T + t) * 32;
        float* o = out + ((it * CL + R) * T + t) * 32;
        if (mode == K1) {
          for (int f = 0; f < 32; ++f) x[f] = in[f];
          xr.sum(x, it, TILES);
          for (int f = 0; f < 32; ++f) o[f] = x[f];
          continue;
        }
        for (int f = 0; f < 16; ++f) s[f] = in[f], dp[f] = in[16 + f];
        xr.send_dp(dp, it);
        xr.sum(s, dp, it);
        for (int f = 0; f < 16; ++f) o[f] = s[f], o[16 + f] = dp[f];
        if (mode == K3_EARLY) xr.read(it, TILES);
        if (mode == K3 || mode == K3_EARLY) {
          // the round-1 bytes rank 0 receives a tile: every peer's partial
          // of each quad it owns, for each of its threads
          long landed = 0;
          for (int u = 0; mode == K3_EARLY && u < T; ++u)
            landed += (CL - 1) * X::owns(0, (u / 32) % X::NW) * 16;
          ds_round_trip<SLOTS>(it, r, t, static_cast<int>(X::SLOT_BYTES),
                               landed);
        }
        if (mode != K3_EARLY) xr.read(it, TILES);
      }
    }
    run_thread<CL, SLOTS, R + 1>(mode, r, t, parts, out);
  }
}

template <int CL, int SLOTS>
int check(Mode mode) {
  memset(smem, 0, sizeof smem);
  ds_bad = 0;
  std::vector<float> parts(TILES * CL * T * 32), out(parts.size());
  srand(CL * 10 + SLOTS);
  for (float& v : parts)
    v = (rand() / static_cast<float>(RAND_MAX) - 0.5f) *
        (rand() % 3 == 0 ? 1e6f : 1.f);
  // thread 0 of each CTA sets up its barriers before any message (the
  // kernel's cluster barrier)
  for (int r = 0; r < CL; ++r) {
    my_rank = r;
    const Xrs<CL, T, 0, SLOTS> xr{0, BAR0};
    xr.init();
  }
  std::vector<std::thread> th;
  for (int r = 0; r < CL; ++r)
    for (int t = 0; t < T; ++t)
      th.emplace_back([&, r, t] {
        my_rank = r;
        threadIdx.x = t;
        run_thread<CL, SLOTS>(mode, r, t, parts.data(), out.data());
      });
  for (std::thread& x : th) x.join();
  int bad = 0;
  for (int it = 0; it < TILES; ++it)
    for (int t = 0; t < T; ++t)
      for (int f = 0; f < 32; ++f) {
        float x[8];
        for (int q = 0; q < CL; ++q)
          x[q] = parts[((it * CL + q) * T + t) * 32 + f];
        const float want = tree_ref(x, CL, 0, 8);
        for (int r = 0; r < CL; ++r) {
          const float got = out[((it * CL + r) * T + t) * 32 + f];
          if (memcmp(&got, &want, 4) != 0) ++bad;
        }
      }
  printf("CL %d slots %d: %d mismatches, %d ds^T\n", CL, SLOTS, bad,
         ds_bad);
  return bad + ds_bad;
}

template <int CL>
int check_all(Mode mode) {
  if (mode == K1 || mode == K3_EARLY) return check<CL, 1>(mode);
  return check<CL, 1>(mode) + check<CL, 2>(mode);
}

int main(int argc, char** argv) {
  const std::string arg = argc > 1 ? argv[1] : "k2";
  const Mode mode = arg == "k1"         ? K1
                    : arg == "k3"       ? K3
                    : arg == "k3-early" ? K3_EARLY
                                        : K2;
  const int bad = check_all<3>(mode) + check_all<4>(mode) +
                  check_all<5>(mode) + check_all<6>(mode) +
                  check_all<7>(mode) + check_all<8>(mode);
  return mode == K3_EARLY ? bad == 0 : bad != 0;
}
