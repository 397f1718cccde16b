// The invert kernel's arithmetic (admm.cuh) with the card's lane split: 512
// host threads per scenario, one barrier standing for __syncthreads().
// tests/test_torch_admm.py builds it with the host C++ compiler and holds
// its Kinv bitwise against the one-lane host build (admm_host.cpp): the
// in-place recursion overwrites blocks that other lanes read, so a missing
// barrier between a step's writes and the next step's reads shows as a
// difference.
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

#include "admm.cuh"

constexpr int kLanes = 512;

extern "C" long long admm_workspace_floats(int kernel, int n, int m) {
  return admm::workspace_floats(kernel, n, m);
}

extern "C" int admm_invert_launch(const float* K, float* Kinv, float* ws, int B, int n,
                                  int ns_iters, void* /*stream*/) {
  const long long nn = (long long)n * n, wf = admm::workspace_floats(admm::INVERT, n, 0);
  std::vector<float> smem(admm::smem_bytes(admm::INVERT, n, 0) / 4);
  for (long long b = 0; b < B; ++b) {
    pthread_barrier_init(&g_barrier, nullptr, kLanes);
    std::vector<std::thread> lanes;
    for (int lane = 0; lane < kLanes; ++lane)
      lanes.emplace_back([&, lane] {
        float* out = Kinv + b * nn;
        admm::with_layout(admm::INVERT, n, 0, smem.data(), ws + b * wf,
                          [&](const admm::Layout& l, auto p) {
          admm::spd_inverse<kLanes, decltype(p)::on_chip>(admm::Team<kLanes>{lane}, K + b * nn, n,
                                                          n, ns_iters, l.X, l.T, out, n, out, n,
                                                          l.tiles);
        });
      });
    for (auto& lane : lanes) lane.join();
    pthread_barrier_destroy(&g_barrier);
  }
  return 0;
}
