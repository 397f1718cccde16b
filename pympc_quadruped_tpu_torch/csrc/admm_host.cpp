// Host build of the condensed-ADMM kernels' arithmetic: the same C
// launchers as admm.cu, running each scenario's block on the CPU with one
// lane (admm::Team<1>, no-op barrier) and heap buffers in place of shared
// memory.  The CPU tests compile it with the host C++ compiler and drive it
// through the same ctypes binding as the CUDA library, so the kernels' own
// per-scenario code (admm.cuh) is checked against the JAX reference without
// a card.
#include <vector>

#include "admm.cuh"

namespace {

using Team = admm::Team<1>;
const Team kTeam{0};

// Shared memory of one block, with Kinv placed as the CUDA kernels place it.
struct Block {
  std::vector<float> smem;
  float* scratch;
  float* kinv;
  float* vecs;
  Block(int kernel, int n, int m, float* ws_kinv) {
    smem.resize(admm::smem_floats(kernel, n, m));
    const bool on_chip = admm::kinv_on_chip(kernel, n, m);
    scratch = smem.data();
    float* next = kernel == admm::ITERATE ? scratch : scratch + admm::SCRATCH_FLOATS;
    kinv = on_chip ? next : ws_kinv;
    vecs = on_chip ? next + (long long)n * (n + 1) : next;
  }
};

}  // namespace

extern "C" long long admm_workspace_floats(int kernel, int n, int m) {
  return admm::workspace_floats(kernel, n, m);
}

extern "C" int admm_invert_launch(const float* K, float* Kinv, float* ws, int B, int n,
                                  int ns_iters, void* /*stream*/) {
  const long long nn = (long long)n * n, wf = admm::workspace_floats(admm::INVERT, n, 0);
  std::vector<float> scratch(admm::SCRATCH_FLOATS);
  for (long long b = 0; b < B; ++b) {
    float* w = ws + b * wf;
    admm::spd_inverse(kTeam, K + b * nn, n, n, ns_iters, Kinv + b * nn, n, w, w + nn,
                      w + 2 * nn, scratch.data());
  }
  return 0;
}

extern "C" int admm_iterate_launch(const float* Kinv, const float* q, const float* d,
                                   const float* es, const float* rho, const float* l,
                                   const float* u, const float* P0, const float* x0,
                                   const float* z0, const float* y0, float* x, float* y,
                                   int B, int n, int m, int iterations, float sigma,
                                   float alpha, void* /*stream*/) {
  Block blk(admm::ITERATE, n, m, nullptr);
  for (long long b = 0; b < B; ++b) {
    admm::IterArgs s{q + b * n, d + b * n, es + b * m, rho + b * m, l + b * m, u + b * m,
                     x0 + b * n, z0 + b * m, y0 + b * m, x + b * n, y + b * m};
    admm::iterate_one(kTeam, Kinv + b * n * n, blk.kinv, s, n, m, P0[2], iterations, sigma,
                      alpha, blk.vecs);
  }
  return 0;
}

extern "C" int admm_fused_launch(const float* K, const float* q, const float* d,
                                 const float* es, const float* rho, const float* l,
                                 const float* u, const float* P0, const float* x0,
                                 const float* z0, const float* y0, float* x, float* y,
                                 float* ws, int B, int n, int m, int iterations, float sigma,
                                 float alpha, int ns_iters, void* /*stream*/) {
  const long long nn = (long long)n * n, wf = admm::workspace_floats(admm::FUSED, n, m);
  for (long long b = 0; b < B; ++b) {
    float* w = ws + b * wf;
    Block blk(admm::FUSED, n, m, w + 2 * nn + admm::stack_floats(n));
    admm::IterArgs s{q + b * n, d + b * n, es + b * m, rho + b * m, l + b * m, u + b * m,
                     x0 + b * n, z0 + b * m, y0 + b * m, x + b * n, y + b * m};
    admm::fused_one(kTeam, K + b * nn, blk.kinv, s, n, m, P0[2], iterations, sigma, alpha,
                    ns_iters, w, blk.scratch, blk.vecs);
  }
  return 0;
}

extern "C" int admm_full_launch(const float* H, const float* g, const float* srow,
                                const float* l, const float* u, const float* U0,
                                const float* lam0, const float* P0, float* U, float* lam,
                                float* ws, int B, int n, int m, int iterations, float sigma,
                                float alpha, int ns_iters, int ruiz_iters, float rho_ineq,
                                float rho_eq, void* /*stream*/) {
  const long long nn = (long long)n * n, wf = admm::workspace_floats(admm::FULL, n, m);
  for (long long b = 0; b < B; ++b) {
    float* w = ws + b * wf;
    Block blk(admm::FULL, n, m, w + 3 * nn + admm::stack_floats(n));
    admm::FullArgs s{H + b * nn, g + b * n, srow + b * m, l + b * m, u + b * m,
                     U0 + b * n, lam0 + b * m, U + b * n, lam + b * m};
    admm::full_one(kTeam, s, blk.kinv, n, m, P0[2], iterations, sigma, alpha, ns_iters,
                   ruiz_iters, rho_ineq, rho_eq, w, blk.scratch, blk.vecs);
  }
  return 0;
}
