// Host build of the condensing kernel's arithmetic: the same C launcher as
// condense.cu, one lane per scenario looping over the batch on the CPU.
// The CPU tests compile it with the host C++ compiler and drive it through
// the same ctypes binding as the CUDA library, so the kernel's own
// per-scenario code (condense.cuh) is checked against the plain condensing
// and the JAX reference without a card.
#include <vector>

#include "condense.cuh"

extern "C" int condense_max_horizon() { return condense::MAX_H; }

extern "C" int condense_launch(const float* Ad, const float* Bd, const float* x_t,
                               const float* X_ref, const float* mv, const float* q,
                               const float* r, float* H, float* g, int B, int h,
                               void* /*stream*/) {
  if (h < 1 || h > condense::MAX_H) return 1;  // cudaErrorInvalidValue
  std::vector<float> smem(condense::smem_floats(h));
  const condense::Team<1> t{0};
  const condense::Args a{Ad, Bd, x_t, X_ref, mv, q, r, H, g};
  for (long long b = 0; b < B; ++b)
    condense::condense_one(t, condense::scenario_args(a, b, h), smem.data(), h);
  return 0;
}
