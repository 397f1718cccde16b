// Host build of the Riccati-ADMM kernel's arithmetic: the same C launcher
// as riccati_admm.cu, one lane per scenario looping over the batch on the
// CPU.  The CPU tests compile it with the host C++ compiler and drive it
// through the same ctypes binding as the CUDA library, so the kernel's own
// per-scenario code (riccati_admm.cuh) is checked against the JAX
// reference without a card.
#include <vector>

#include "riccati_admm.cuh"

extern "C" int riccati_admm_launch(
    const float* A, const float* Bd, const float* hu, const float* mask,
    const float* q2, const float* mu, const float* rho, const float* qx,
    const float* xt, const float* gate, const float* lo, const float* hi,
    const float* u0, const float* z0, const float* y0, float* U, float* Y,
    int B, int h, int iterations, float sigma, float alpha, void* /*stream*/) {
  riccati_admm::Operands o{A, Bd, hu, mask, q2, mu, rho, qx, xt, gate, lo, hi,
                           u0, z0, y0, U, Y, B, h, iterations, sigma, alpha};
  std::vector<float> sm(riccati_admm::group_floats(h));
  const riccati_admm::Team<1> t{0};
  for (long long b = 0; b < B; ++b) riccati_admm::solve_one(t, o, b, sm.data(), true);
  return 0;
}
