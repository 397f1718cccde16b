// The fused and full condensed-ADMM kernels on Hopper (sm_90a), one launch
// each for a whole condensed solve: one block of 512 threads per scenario.
// The arithmetic lives in admm.cuh (fused_one, full_one); this file holds
// the kernels and their C launchers, bound from Python with ctypes
// (pympc_quadruped_tpu_torch/ops/qp/admm_cuda.py).  It is a translation
// unit of its own, built in parallel with admm.cu.
//
// They replace the TPU kernels of pympc_quadruped_tpu/ops/qp/admm_pallas.py:
//   admm_fused_kernel  <- _fused_kernel (:374, wrapper _iterate_fused :647):
//                         the invert and iterate kernels' work in one launch;
//   admm_full_kernel   <- _full_kernel (:417, wrapper _solve_full :533):
//                         everything after build_qp: Ruiz scaling, cone-row
//                         scaling, per-row rho, K assembly, the inverse, the
//                         warm-start map, the sweeps and the unscaling.
//
// What bounds them on the H100 (B = 4096, h = 16, n = 192, m = 320, 40
// sweeps; the measured times are in PERF.md): the inverse's ~38 MFLOP and
// the sweeps' ~3 MFLOP per scenario, ~2.5 ms at the 67 TFLOP/s FP32 rate,
// against ~0.7 GB read once (K or H, the vectors), ~0.2 ms at 3.35 TB/s:
// bound by operations.  As in the invert kernel, what bounds them in fact
// is the inverse's chain of small dependent steps, so they run its code
// as it is (admm.cu), at its 512 lanes, with X = Kinv left in shared
// memory (ld n + 1) and the Newton-Schulz product R in a device-memory
// workspace (X and R do not both fit on chip).  The design keeps the rest
// off that chain's way:
// - The sweeps run on Kinv in registers, as the iterate kernel's do: each
//   of 16 warps owns 12 rows of X, and each lane keeps 8 x 6 of its tile in
//   registers (48 floats; all 72 do not fit beside the cone step in the
//   128 registers of a 512-thread block, and ptxas spilled them) and reads
//   the other 4 x 6 from X in shared memory every sweep.  A sweep's product
//   is 12 independent 6-term fmaf chains a lane and a shuffle tree of 18
//   shuffles, in admm.cuh's row_times order (the fused kernel's x, y equal
//   the invert and iterate kernels', bit for bit).  The vectors stay in
//   shared memory, one lane a cone block.
// - The full kernel's set-up runs in X's buffer while the buffer is free:
//   H read once by 16-byte loads, each row's abs-max taken by one warp,
//   scaled in place, the 3x3 blocks added; K goes to the workspace once,
//   for the Newton-Schulz step, and X = sym(K) starts the recursion.
// For n > 192 (h >= 17) X does not fit in shared memory and lies in the
// workspace; the sweeps then read it there, a row a lane.
#include <cuda_runtime.h>

#include "admm.cuh"

namespace {

constexpr int kThreads = admm::FUSED_THREADS;
using Team = admm::Team<kThreads>;

__global__ void __launch_bounds__(kThreads, 1)
admm_fused_kernel(const float* K, admm::IterArgs a, const float* P0, float* ws, int n, int m,
                  int iterations, float sigma, float alpha, int ns_iters, long long ws_floats) {
  extern __shared__ __align__(16) float smem[];
  const Team t{(int)threadIdx.x};
  const long long b = blockIdx.x, nn = (long long)n * n;
  const admm::IterArgs s = admm::scenario_args(a, b, n, m);
  float* w = ws + b * ws_floats;
  admm::with_layout(admm::FUSED, n, m, smem, w, [&](const admm::Layout& l, auto p) {
    admm::fused_one<kThreads, decltype(p)::on_chip>(t, K + b * nn, l, s, n, m, P0[2], iterations,
                                                    sigma, alpha, ns_iters);
  });
}

__global__ void __launch_bounds__(kThreads, 1)
admm_full_kernel(admm::FullArgs a, const float* P0, float* ws, int n, int m, int iterations,
                 float sigma, float alpha, int ns_iters, int ruiz_iters, float rho_ineq,
                 float rho_eq, long long ws_floats) {
  extern __shared__ __align__(16) float smem[];
  const Team t{(int)threadIdx.x};
  const long long b = blockIdx.x;
  const admm::FullArgs s = admm::scenario_args(a, b, n, m);
  float* w = ws + b * ws_floats;
  admm::with_layout(admm::FULL, n, m, smem, w, [&](const admm::Layout& l, auto p) {
    admm::full_one<kThreads, decltype(p)::on_chip>(t, s, l, n, m, P0[2], iterations, sigma, alpha,
                                                   ns_iters, ruiz_iters, rho_ineq, rho_eq);
  });
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename F>
cudaError_t launch_prep(F* kernel, long long smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int admm_fused_launch(const float* K, const float* q, const float* d,
                                 const float* es, const float* rho, const float* l,
                                 const float* u, const float* P0, const float* x0,
                                 const float* z0, const float* y0, float* x, float* y,
                                 float* ws, int B, int n, int m, int iterations, float sigma,
                                 float alpha, int ns_iters, void* stream) {
  if (B == 0) return 0;
  const long long smem = admm::smem_bytes(admm::FUSED, n, m);
  cudaError_t err = launch_prep(admm_fused_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  admm::IterArgs a{q, d, es, rho, l, u, x0, z0, y0, x, y};
  admm_fused_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, a, P0, ws, n, m, iterations, sigma, alpha, ns_iters,
      admm::workspace_floats(admm::FUSED, n, m));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int admm_full_launch(const float* H, const float* g, const float* srow,
                                const float* l, const float* u, const float* U0,
                                const float* lam0, const float* P0, float* U, float* lam,
                                float* ws, int B, int n, int m, int iterations, float sigma,
                                float alpha, int ns_iters, int ruiz_iters, float rho_ineq,
                                float rho_eq, void* stream) {
  if (B == 0) return 0;
  const long long smem = admm::smem_bytes(admm::FULL, n, m);
  cudaError_t err = launch_prep(admm_full_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  admm::FullArgs a{H, g, srow, l, u, U0, lam0, U, lam};
  admm_full_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, P0, ws, n, m, iterations, sigma, alpha, ns_iters, ruiz_iters, rho_ineq, rho_eq,
      admm::workspace_floats(admm::FULL, n, m));
  return static_cast<int>(cudaGetLastError());
}

// How the fused (kernel = admm::FUSED) or full (admm::FULL) kernel launches
// at (n, m): out[0] threads a block, out[1] dynamic shared memory bytes a
// block, out[2] blocks resident per SM.
extern "C" int admm_fused_config(int kernel, int n, int m, int* out) {
  const long long smem = admm::smem_bytes(kernel, n, m);
  const bool full = kernel == admm::FULL;
  cudaError_t err =
      full ? launch_prep(admm_full_kernel, smem) : launch_prep(admm_fused_kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = full ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, admm_full_kernel, kThreads,
                                                                smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, admm_fused_kernel,
                                                                kThreads, smem);
  out[0] = kThreads;
  out[1] = (int)smem;
  out[2] = blocks;
  return static_cast<int>(err);
}
