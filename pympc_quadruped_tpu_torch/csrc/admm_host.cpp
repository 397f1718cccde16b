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

// Shared memory of one block, sized as the CUDA launchers size it; the
// buffers are placed by admm::layout, as in the CUDA kernels.
std::vector<float> block_smem(int kernel, int n, int m) {
  return std::vector<float>(admm::smem_bytes(kernel, n, m) / 4);
}

}  // namespace

extern "C" long long admm_workspace_floats(int kernel, int n, int m) {
  return admm::workspace_floats(kernel, n, m);
}

extern "C" int admm_invert_launch(const float* K, float* Kinv, float* ws, int B, int n,
                                  int ns_iters, void* /*stream*/) {
  const long long nn = (long long)n * n, wf = admm::workspace_floats(admm::INVERT, n, 0);
  std::vector<float> smem = block_smem(admm::INVERT, n, 0);
  for (long long b = 0; b < B; ++b) {
    float* out = Kinv + b * nn;
    float* w = ws + b * wf;
    admm::with_layout(admm::INVERT, n, 0, smem.data(), w, [&](const admm::Layout& l, auto p) {
      admm::spd_inverse<1, decltype(p)::on_chip>(kTeam, K + b * nn, n, n, ns_iters, l.X, l.T, out,
                                                 n, out, n, l.tiles);
    });
  }
  return 0;
}

extern "C" int admm_iterate_launch(const float* Kinv, const float* q, const float* d,
                                   const float* es, const float* rho, const float* l,
                                   const float* u, const float* P0, const float* x0,
                                   const float* z0, const float* y0, float* x, float* y,
                                   int B, int n, int m, int iterations, float sigma,
                                   float alpha, void* /*stream*/) {
  std::vector<float> smem = block_smem(admm::ITERATE, n, m);
  const bool on_chip = admm::on_chip(admm::ITERATE, n, m);
  float* kinv = on_chip ? smem.data() : nullptr;
  float* vecs = on_chip ? smem.data() + admm::x_floats(n) : smem.data();
  for (long long b = 0; b < B; ++b) {
    admm::IterArgs s{q + b * n, d + b * n, es + b * m, rho + b * m, l + b * m, u + b * m,
                     x0 + b * n, z0 + b * m, y0 + b * m, x + b * n, y + b * m};
    admm::iterate_one(kTeam, Kinv + b * n * n, kinv, s, n, m, P0[2], iterations, sigma, alpha,
                      vecs);
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
  std::vector<float> smem = block_smem(admm::FUSED, n, m);
  for (long long b = 0; b < B; ++b) {
    admm::IterArgs s{q + b * n, d + b * n, es + b * m, rho + b * m, l + b * m, u + b * m,
                     x0 + b * n, z0 + b * m, y0 + b * m, x + b * n, y + b * m};
    float* w = ws + b * wf;
    admm::with_layout(admm::FUSED, n, m, smem.data(), w, [&](const admm::Layout& lay, auto p) {
      admm::fused_one<1, decltype(p)::on_chip>(kTeam, K + b * nn, lay, s, n, m, P0[2], iterations,
                                               sigma, alpha, ns_iters);
    });
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
  std::vector<float> smem = block_smem(admm::FULL, n, m);
  for (long long b = 0; b < B; ++b) {
    admm::FullArgs s{H + b * nn, g + b * n, srow + b * m, l + b * m, u + b * m,
                     U0 + b * n, lam0 + b * m, U + b * n, lam + b * m};
    float* w = ws + b * wf;
    admm::with_layout(admm::FULL, n, m, smem.data(), w, [&](const admm::Layout& lay, auto p) {
      admm::full_one<1, decltype(p)::on_chip>(kTeam, s, lay, n, m, P0[2], iterations, sigma, alpha,
                                              ns_iters, ruiz_iters, rho_ineq, rho_eq);
    });
  }
  return 0;
}
