// Sparse Riccati-ADMM MPC solve on Hopper (sm_90a), one thread per scenario.
//
// Replaces the TPU kernel pympc_quadruped_tpu/ops/qp/riccati_pallas.py::
// _solve_kernel (Pallas, batch on the 128-wide lane axis, factors held in
// VMEM).  The arithmetic lives in riccati_admm.cuh; this file holds the
// kernel and its C launcher, bound from Python with ctypes
// (pympc_quadruped_tpu_torch/ops/qp/riccati_cuda.py).
//
// What the TPU version needed and this one drops: the 128-lane tiling and
// identity-problem batch padding (the kernel masks its ragged edge), the
// scatter-free one-hot Gauss-Jordan (a plain in-place pivot-free one on a
// 12x24 augmented matrix), and the duplicate row-form copies of A, B and K
// (one copy is indexed both ways, so the per-step factors are 300 floats:
// K 156 + M^-1 144, not 456).
//
// What bounds it (reckoned from the code at h=16; the measured times are in
// PERF.md): the factorization is ~0.28 MFMA and 40 ADMM sweeps ~0.7 MFMA
// per scenario, ~2 MFLOP, so ~8 GFLOP at B=4096, about 0.1 ms of the
// H100's non-tensor FP32 rate.  Each sweep re-reads the ~19 KB of factors
// per scenario, ~78 MB per sweep at B=4096, ~3 GB per solve: about 1 ms at
// 3.35 TB/s when they do not stay in the 50 MB L2.  So this design is bound
// by memory traffic.  It keeps that traffic coalesced (operands and the
// (h*332, B) factor scratch are batch-minor, so a warp's 32 threads read
// 32 neighbouring floats) and keeps P, PA, the 12x24 Gauss-Jordan block
// and the 13-wide vectors in per-thread arrays (local memory where they
// spill).  Keeping factors on chip (warp per scenario, shared memory) is
// the next step, not this one.
#include <cuda_runtime.h>

#include "riccati_admm.cuh"

namespace {

constexpr int kThreads = 64;  // small blocks: B=4096 spreads over 64 blocks

__global__ void __launch_bounds__(kThreads) riccati_admm_kernel(riccati_admm::Operands o) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= o.B) return;
  riccati_admm::solve_one(o, b);
}

}  // namespace

extern "C" int riccati_admm_launch(
    const float* A, const float* Bd, const float* hu, const float* mask,
    const float* q2, const float* mu, const float* rho, const float* qx,
    const float* xt, const float* gate, const float* lo, const float* hi,
    const float* u0, const float* z0, const float* y0,
    float* U, float* Y, float* scratch,
    int B, int h, int iterations, float sigma, float alpha, void* stream) {
  riccati_admm::Operands o{A, Bd, hu, mask, q2, mu, rho, qx, xt, gate, lo, hi,
                           u0, z0, y0, U, Y, scratch, B, h, iterations, sigma, alpha};
  const int blocks = (B + kThreads - 1) / kThreads;
  riccati_admm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(o);
  return static_cast<int>(cudaGetLastError());
}
