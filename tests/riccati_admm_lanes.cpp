// The Riccati-ADMM kernel's arithmetic (riccati_admm.cuh) with the card's
// lane split: 16 host threads per scenario, one barrier standing for the
// warp barrier.  tests/test_torch_riccati.py builds it with the host C++
// compiler and holds it bitwise against the one-lane host build
// (riccati_admm_host.cpp): a row that no lane owns, or a missing barrier
// between a phase's writes and the next phase's reads, shows as a
// difference.
#include <pthread.h>

#include <thread>
#include <vector>

// Compile the header's card path on the host.
#define __CUDA_ARCH__ 900
struct float4 {
  float x, y, z, w;
};
static pthread_barrier_t g_barrier;
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { pthread_barrier_wait(&g_barrier); }

#include "riccati_admm.cuh"

constexpr int kLanes = 16;

extern "C" int riccati_admm_launch(
    const float* A, const float* Bd, const float* hu, const float* mask,
    const float* q2, const float* mu, const float* rho, const float* qx,
    const float* xt, const float* gate, const float* lo, const float* hi,
    const float* u0, const float* z0, const float* y0, float* U, float* Y,
    int B, int h, int iterations, float sigma, float alpha, void* /*stream*/) {
  riccati_admm::Operands o{A, Bd, hu, mask, q2, mu, rho, qx, xt, gate, lo, hi,
                           u0, z0, y0, U, Y, B, h, iterations, sigma, alpha};
  std::vector<float> sm(riccati_admm::group_floats(h));
  for (long long b = 0; b < B; ++b) {
    pthread_barrier_init(&g_barrier, nullptr, kLanes);
    std::vector<std::thread> lanes;
    for (int l = 0; l < kLanes; ++l)
      lanes.emplace_back([&, l] {
        riccati_admm::solve_one(riccati_admm::Team<kLanes>{l}, o, b, sm.data(), true);
      });
    for (auto& lane : lanes) lane.join();
    pthread_barrier_destroy(&g_barrier);
  }
  return 0;
}
