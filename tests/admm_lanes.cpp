// The condensed kernels' arithmetic (admm.cuh) with the card's lane
// splits, as host threads: the invert, fused and full kernels' 512 lanes
// (16 warps: the fused and full kernels' register sweeps and the full
// kernel's row maxima shuffle), the wide iterate kernel's 256, and the
// iterate kernel's register path, 384 lanes in 12 warps of persistent
// blocks.  One barrier stands for __syncthreads(), and each warp has an
// exchange array and a barrier of its own standing for __shfl_xor_sync.
// tests/test_torch_admm.py builds it with the host C++ compiler and holds
// its outputs bitwise against the one-lane host build (admm_host.cpp): the
// in-place recursion overwrites blocks that other lanes read, and the
// sweeps read vectors that other lanes write, so a missing barrier between
// a step's writes and the next step's reads shows as a difference.
#include <pthread.h>

#include <thread>
#include <vector>

// Compile the header's card path on the host.
#define __CUDA_ARCH__ 900
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
static pthread_barrier_t g_barrier;
inline void __syncthreads() { pthread_barrier_wait(&g_barrier); }

constexpr int kMaxWarps = 16;
struct Warp {
  pthread_barrier_t barrier;
  float exchange[32];
};
static Warp g_warps[kMaxWarps];
static thread_local int t_thread = 0;  // the calling lane's index in its block

inline float __shfl_xor_sync(unsigned /*mask*/, float v, int lane_mask) {
  Warp& w = g_warps[t_thread / 32];
  const int lane = t_thread % 32;
  w.exchange[lane] = v;
  pthread_barrier_wait(&w.barrier);
  const float r = w.exchange[lane ^ lane_mask];
  pthread_barrier_wait(&w.barrier);
  return r;
}

#include "admm.cuh"

namespace {

// Run f(lane) on `lanes` host threads, as one block.
template <class F>
void run_block(int lanes, F f) {
  pthread_barrier_init(&g_barrier, nullptr, lanes);
  for (int w = 0; w < lanes / 32; ++w) pthread_barrier_init(&g_warps[w].barrier, nullptr, 32);
  std::vector<std::thread> threads;
  for (int lane = 0; lane < lanes; ++lane)
    threads.emplace_back([&, lane] {
      t_thread = lane;
      f(lane);
    });
  for (auto& th : threads) th.join();
  for (int w = 0; w < lanes / 32; ++w) pthread_barrier_destroy(&g_warps[w].barrier);
  pthread_barrier_destroy(&g_barrier);
}

constexpr int kInvertLanes = 512, kWideLanes = 256, kFusedLanes = admm::FUSED_THREADS;
// Persistent blocks of the iterate kernel's register path: few enough that
// a block walks several scenarios of a small batch, prefetching each next
// one.
constexpr int kIterateBlocks = 2;

}  // namespace

extern "C" int admm_invert_launch(const float* K, float* Kinv, float* ws, int B, int n,
                                  int ns_iters, void* /*stream*/) {
  const long long nn = (long long)n * n, wf = admm::workspace_floats(admm::INVERT, n, 0);
  std::vector<float> smem(admm::smem_bytes(admm::INVERT, n, 0) / 4);
  for (long long b = 0; b < B; ++b)
    run_block(kInvertLanes, [&](int lane) {
      float* out = Kinv + b * nn;
      admm::with_layout(admm::INVERT, n, 0, smem.data(), ws + b * wf,
                        [&](const admm::Layout& l, auto p) {
        admm::spd_inverse<kInvertLanes, decltype(p)::on_chip>(
            admm::Team<kInvertLanes>{lane}, K + b * nn, n, n, ns_iters, l.X, l.T, out, n, out, n,
            l.tiles);
      });
    });
  return 0;
}

// The register path for n <= admm::REG_N; above, the wide kernel's split
// (256 lanes a scenario, Kinv in shared memory or read in place).
extern "C" int admm_iterate_launch(const float* Kinv, const float* q, const float* d,
                                   const float* es, const float* rho, const float* l,
                                   const float* u, const float* P0, const float* x0,
                                   const float* z0, const float* y0, float* x, float* y,
                                   int B, int n, int m, int iterations, float sigma,
                                   float alpha, void* /*stream*/) {
  const admm::IterArgs a{q, d, es, rho, l, u, x0, z0, y0, x, y};
  if (!admm::in_registers(n)) {
    const bool on_chip = admm::on_chip(admm::ITERATE, n, m);
    std::vector<float> smem(admm::smem_bytes(admm::ITERATE, n, m) / 4);
    for (long long b = 0; b < B; ++b)
      run_block(kWideLanes, [&](int lane) {
        admm::iterate_one(admm::Team<kWideLanes>{lane}, Kinv + b * n * n,
                          on_chip ? smem.data() : nullptr, admm::scenario_args(a, b, n, m), n, m,
                          P0[2], iterations, sigma, alpha,
                          on_chip ? smem.data() + admm::x_floats(n) : smem.data());
      });
    return 0;
  }
  const int blocks = B < kIterateBlocks ? B : kIterateBlocks;
  for (int block = 0; block < blocks; ++block) {
    std::vector<float> smem(admm::resident_floats(n, m));
    run_block(admm::RES_THREADS, [&](int lane) {
      admm::iterate_resident(admm::Team<admm::RES_THREADS>{lane}, Kinv, a, B, n, m, P0[2],
                             iterations, sigma, alpha, block, blocks, smem.data());
    });
  }
  return 0;
}

extern "C" int admm_fused_launch(const float* K, const float* q, const float* d,
                                 const float* es, const float* rho, const float* l,
                                 const float* u, const float* P0, const float* x0,
                                 const float* z0, const float* y0, float* x, float* y,
                                 float* ws, int B, int n, int m, int iterations, float sigma,
                                 float alpha, int ns_iters, void* /*stream*/) {
  const long long wf = admm::workspace_floats(admm::FUSED, n, m);
  std::vector<float> smem(admm::smem_bytes(admm::FUSED, n, m) / 4);
  const admm::IterArgs a{q, d, es, rho, l, u, x0, z0, y0, x, y};
  for (long long b = 0; b < B; ++b)
    run_block(kFusedLanes, [&](int lane) {
      admm::with_layout(admm::FUSED, n, m, smem.data(), ws + b * wf,
                        [&](const admm::Layout& lay, auto p) {
        admm::fused_one<kFusedLanes, decltype(p)::on_chip>(
            admm::Team<kFusedLanes>{lane}, K + b * n * n, lay, admm::scenario_args(a, b, n, m),
            n, m, P0[2], iterations, sigma, alpha, ns_iters);
      });
    });
  return 0;
}

extern "C" int admm_full_launch(const float* H, const float* g, const float* srow,
                                const float* l, const float* u, const float* U0,
                                const float* lam0, const float* P0, float* U, float* lam,
                                float* ws, int B, int n, int m, int iterations, float sigma,
                                float alpha, int ns_iters, int ruiz_iters, float rho_ineq,
                                float rho_eq, void* /*stream*/) {
  const long long wf = admm::workspace_floats(admm::FULL, n, m);
  std::vector<float> smem(admm::smem_bytes(admm::FULL, n, m) / 4);
  const admm::FullArgs a{H, g, srow, l, u, U0, lam0, U, lam};
  for (long long b = 0; b < B; ++b)
    run_block(kFusedLanes, [&](int lane) {
      admm::with_layout(admm::FULL, n, m, smem.data(), ws + b * wf,
                        [&](const admm::Layout& lay, auto p) {
        admm::full_one<kFusedLanes, decltype(p)::on_chip>(
            admm::Team<kFusedLanes>{lane}, admm::scenario_args(a, b, n, m), lay, n, m, P0[2],
            iterations, sigma, alpha, ns_iters, ruiz_iters, rho_ineq, rho_eq);
      });
    });
  return 0;
}
