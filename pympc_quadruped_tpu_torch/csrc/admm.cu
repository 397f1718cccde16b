// The condensed-ADMM kernels on Hopper (sm_90a): one thread block per
// scenario, of 512 threads (invert) or 256 (the others).  The arithmetic
// lives in admm.cuh; this file holds the four kernels and their C
// launchers, bound from Python with ctypes
// (pympc_quadruped_tpu_torch/ops/qp/admm_cuda.py).
//
// They replace the TPU kernels of pympc_quadruped_tpu/ops/qp/admm_pallas.py:
//   admm_invert_kernel   <- _invert_kernel (:242, wrapper invert_spd :266)
//   admm_iterate_kernel  <- _kernel (:38, wrapper _iterate :81)
//   admm_fused_kernel    <- _fused_kernel (:374, wrapper _iterate_fused :647)
//   admm_full_kernel     <- _full_kernel (:417, wrapper _solve_full :533)
// The Pallas kernels put a tile of scenarios on the grid and padded n to a
// power of two (192 -> 256) and B to a Mosaic-legal tile; these kernels take
// any n = 12h and any B, split the recursion at n/2 (192 -> 96 -> 48 -> 24
// -> 12), and mask their own ragged tiles.
//
// What bounds them on the H100 (reckoned from the code at B = 4096, h = 16,
// n = 192, m = 320; the measured times are in PERF.md):
// - invert: ~38 MFLOP per scenario (the recursion ~4/3 n^3, one
//   Newton-Schulz step 4 n^3), ~155 GFLOP in all, ~2.3 ms at the 67 TFLOP/s
//   FP32 rate, against 1.2 GB of K and Kinv, ~0.37 ms at 3.35 TB/s: bound by
//   operations.  But the recursion is a chain of hundreds of small
//   dependent steps (16 Gauss-Jordan leaves of 12 pivots, four products a
//   level), so what bounds it is each step's latency.  The kernel keeps
//   every operand of the recursion in shared memory: it inverts X = sym(K)
//   in place in one n x (n+1) buffer (148 KB at h = 16) and reads K from
//   device memory once.  The recursion's products read their operands
//   where they lie, with no tile copies and one barrier each, on a 32 x 16
//   grid of lanes whose micro-tiles are sized to the product.  The
//   Newton-Schulz step runs by 64-column panels T = 2I - K X[:, J] (48 KB,
//   on chip), each lane computing 6 x 4 outputs of a 192-row panel; it
//   writes R[:, J] = X T straight to Kinv and then symmetrizes Kinv in
//   place by tile pairs while it is hot in L2; no device-memory
//   workspace.  With the 17 KB of tiles a block takes 210 KB: one block of
//   512 threads per SM.  FP32 FMA only: no TF32 or bf16 tensor-core
//   products, whose rounding NaN-poisons the recursion (admm_pallas.py:114).
//   From h = 17 the buffer does not fit, and the same code runs on it in a
//   device-memory workspace.
// - iterate: per sweep one n x n matrix-vector product (2 n^2 flop) and
//   O(m) cone work; 40 sweeps are ~12 GFLOP, ~0.18 ms, against one read of
//   Kinv (604 MB), ~0.18 ms.  Kinv goes to dynamic shared memory once
//   (n (n+1) floats, 148,224 B at n = 192, rows padded by one float so a
//   warp's row reads fall in 32 different banks) and every sweep reads it
//   there.  From n = 240 (h = 20) it does not fit in the 232,448 B a block
//   may use, and the kernel reads Kinv from device memory every sweep.
// - fused and full: invert + iterate in one launch, with the invert
//   kernel's in-place inverse: X becomes Kinv in shared memory and never
//   goes back to device memory (from h = 17 it stays in the workspace).
//   The Newton-Schulz product R (n x n) goes to a device-memory workspace:
//   X is read whole by every panel, and the two do not both fit on chip.
//   Full also does the Ruiz passes and K assembly on a workspace copy of H.
#include <cuda_runtime.h>

#include "admm.cuh"

namespace {

constexpr int kThreads = 256;
using Team = admm::Team<kThreads>;

// One block per SM: at h = 16 the block's buffers take 210 KB of shared
// memory.  512 threads (at most 128 registers each) hide more of each
// product's latency than 256 (measured in PERF.md).
constexpr int kInvertThreads = 512;
__global__ void __launch_bounds__(kInvertThreads, 1)
admm_invert_kernel(const float* K, float* Kinv, float* ws, int n, int ns_iters,
                   long long ws_floats) {
  extern __shared__ __align__(16) float smem[];
  const admm::Team<kInvertThreads> t{(int)threadIdx.x};
  const long long b = blockIdx.x, nn = (long long)n * n;
  float* out = Kinv + b * nn;
  float* w = ws + b * ws_floats;
  admm::with_layout(admm::INVERT, n, 0, smem, w, [&](const admm::Layout& l, auto p) {
    admm::spd_inverse<kInvertThreads, decltype(p)::on_chip>(t, K + b * nn, n, n, ns_iters, l.X,
                                                            l.T, out, n, out, n, l.tiles);
  });
}

__global__ void __launch_bounds__(kThreads)
admm_iterate_kernel(const float* Kinv, admm::IterArgs a, const float* P0, int n, int m,
                    int iterations, float sigma, float alpha, int kinv_on_chip) {
  extern __shared__ __align__(16) float smem[];
  const Team t{(int)threadIdx.x};
  const long long b = blockIdx.x;
  admm::IterArgs s{a.q + b * n, a.d + b * n, a.es + b * m, a.rho + b * m, a.lo + b * m,
                   a.hi + b * m, a.x0 + b * n, a.z0 + b * m, a.y0 + b * m, a.x + b * n,
                   a.y + b * m};
  float* kinv = kinv_on_chip ? smem : nullptr;
  float* vecs = kinv_on_chip ? smem + admm::x_floats(n) : smem;
  admm::iterate_one(t, Kinv + b * n * n, kinv, s, n, m, P0[2], iterations, sigma, alpha, vecs);
}

__global__ void __launch_bounds__(kThreads)
admm_fused_kernel(const float* K, admm::IterArgs a, const float* P0, float* ws, int n, int m,
                  int iterations, float sigma, float alpha, int ns_iters, long long ws_floats) {
  extern __shared__ __align__(16) float smem[];
  const Team t{(int)threadIdx.x};
  const long long b = blockIdx.x, nn = (long long)n * n;
  admm::IterArgs s{a.q + b * n, a.d + b * n, a.es + b * m, a.rho + b * m, a.lo + b * m,
                   a.hi + b * m, a.x0 + b * n, a.z0 + b * m, a.y0 + b * m, a.x + b * n,
                   a.y + b * m};
  float* w = ws + b * ws_floats;
  admm::with_layout(admm::FUSED, n, m, smem, w, [&](const admm::Layout& l, auto p) {
    admm::fused_one<kThreads, decltype(p)::on_chip>(t, K + b * nn, l, s, n, m, P0[2], iterations,
                                                    sigma, alpha, ns_iters);
  });
}

__global__ void __launch_bounds__(kThreads)
admm_full_kernel(admm::FullArgs a, const float* P0, float* ws, int n, int m, int iterations,
                 float sigma, float alpha, int ns_iters, int ruiz_iters, float rho_ineq,
                 float rho_eq, long long ws_floats) {
  extern __shared__ __align__(16) float smem[];
  const Team t{(int)threadIdx.x};
  const long long b = blockIdx.x, nn = (long long)n * n;
  admm::FullArgs s{a.H + b * nn, a.g + b * n, a.srow + b * m, a.l + b * m, a.u + b * m,
                   a.U0 + b * n, a.lam0 + b * m, a.U + b * n, a.lam + b * m};
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

extern "C" long long admm_workspace_floats(int kernel, int n, int m) {
  return admm::workspace_floats(kernel, n, m);
}

extern "C" int admm_invert_launch(const float* K, float* Kinv, float* ws, int B, int n,
                                  int ns_iters, void* stream) {
  if (B == 0) return 0;
  const long long smem = admm::smem_bytes(admm::INVERT, n, 0);
  cudaError_t err = launch_prep(admm_invert_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_invert_kernel<<<B, kInvertThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, Kinv, ws, n, ns_iters, admm::workspace_floats(admm::INVERT, n, 0));
  return static_cast<int>(cudaGetLastError());
}

// What the card keeps resident of the invert kernel at n: out[0] blocks
// per SM, out[1] dynamic shared memory bytes per block.
extern "C" int admm_invert_occupancy(int n, int* out) {
  const long long smem = admm::smem_bytes(admm::INVERT, n, 0);
  cudaError_t err = launch_prep(admm_invert_kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, admm_invert_kernel, kInvertThreads,
                                                        smem);
  out[0] = blocks;
  out[1] = (int)smem;
  return static_cast<int>(err);
}

extern "C" int admm_iterate_launch(const float* Kinv, const float* q, const float* d,
                                   const float* es, const float* rho, const float* l,
                                   const float* u, const float* P0, const float* x0,
                                   const float* z0, const float* y0, float* x, float* y,
                                   int B, int n, int m, int iterations, float sigma,
                                   float alpha, void* stream) {
  if (B == 0) return 0;
  const long long smem = admm::smem_bytes(admm::ITERATE, n, m);
  cudaError_t err = launch_prep(admm_iterate_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  admm::IterArgs a{q, d, es, rho, l, u, x0, z0, y0, x, y};
  admm_iterate_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Kinv, a, P0, n, m, iterations, sigma, alpha, admm::on_chip(admm::ITERATE, n, m));
  return static_cast<int>(cudaGetLastError());
}

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
