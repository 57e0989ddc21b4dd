// A host simulation of the backward's balanced exchange (Xrs in
// tensorforth_tpu_torch/ops/csrc/sm90_gemm.cuh), compiled by g++ from the
// kernel's own source: tests/test_torch_bwd_xrs.py cuts the struct out of
// the header into xrs_body.h and builds this file against it.
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
// cluster_sum's tree of the cluster's partials, bit for bit, with one slot
// and with two.  A wait that never completes aborts.  Prints one line a
// case; exits 1 on any mismatch.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
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

// a CTA's shared memory: the slots from 0, the barriers from BAR0 on, 8
// bytes apart; a cluster address is rank << 20 | offset
static unsigned char smem[8][1 << 17];
static const uint32_t BAR0 = 1 << 16;
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
  for (long spin = 0;; ++spin) {
    {
      std::lock_guard<std::mutex> l(gm);
      if ((b.phase & 1) != static_cast<int>(parity)) return;
    }
    if (spin > 200000000) {
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
static Warp warps[8][8];
static void __syncwarp() {
  Warp& w = warps[my_rank][threadIdx.x / 32];
  std::unique_lock<std::mutex> l(w.m);
  const int gen = w.gen;
  if (++w.arrived == 32) {
    w.arrived = 0;
    ++w.gen;
    w.cv.notify_all();
  } else {
    w.cv.wait(l, [&] { return w.gen != gen; });
  }
}

#include "xrs_body.h"

static float tree_ref(const float* x, int cl, int b, int h) {
  if (h == 1) return x[b];
  const float lo = tree_ref(x, cl, b, h / 2);
  return b + h / 2 < cl ? lo + tree_ref(x, cl, b + h / 2, h / 2) : lo;
}

constexpr int T = 256, TILES = 4;

// thread t of CTA r: each tile, its partial through the exchange, as
// bwd_body calls it (dp's floats first, then the sum, then the read)
template <int CL, int SLOTS, int R = 0>
void run_thread(int r, int t, const float* parts, float* out) {
  if constexpr (R < CL) {
    if (r == R) {
      const Xrs<CL, T, R, SLOTS> xr{static_cast<uint32_t>(t * 16), BAR0};
      float s[16], dp[16];
      for (int it = 0; it < TILES; ++it) {
        const float* in = parts + ((it * CL + R) * T + t) * 32;
        for (int f = 0; f < 16; ++f) s[f] = in[f], dp[f] = in[16 + f];
        xr.send_dp(dp, it);
        xr.sum(s, dp, it);
        float* o = out + ((it * CL + R) * T + t) * 32;
        for (int f = 0; f < 16; ++f) o[f] = s[f], o[16 + f] = dp[f];
        xr.read(it, TILES);
      }
    }
    run_thread<CL, SLOTS, R + 1>(r, t, parts, out);
  }
}

template <int CL, int SLOTS>
int check() {
  memset(smem, 0, sizeof smem);
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
        run_thread<CL, SLOTS>(r, t, parts.data(), out.data());
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
  printf("CL %d slots %d: %d mismatches\n", CL, SLOTS, bad);
  return bad;
}

int main() {
  const int bad = check<3, 1>() + check<3, 2>() + check<4, 1>() +
                  check<4, 2>() + check<5, 1>() + check<5, 2>() +
                  check<6, 1>() + check<6, 2>() + check<7, 1>() +
                  check<7, 2>() + check<8, 1>() + check<8, 2>();
  return bad != 0;
}
