// Sparse Riccati-ADMM MPC solve on Hopper (sm_90a): one 16-lane group (half
// a warp) per scenario, several scenarios per block, each scenario's factors
// and iteration state in shared memory.
//
// Replaces the TPU kernel pympc_quadruped_tpu/ops/qp/riccati_pallas.py::
// _solve_kernel (Pallas, batch on the 128-wide lane axis, factors held in
// VMEM).  The arithmetic lives in riccati_admm.cuh; this file holds the
// kernel and its C launcher, bound from Python with ctypes
// (pympc_quadruped_tpu_torch/ops/qp/riccati_cuda.py).
//
// What bounds it.  Per scenario at h=16 the work is ~2 MFLOP (the
// factorization ~0.28 MFMA, 40 sweeps ~0.7 MFMA), ~9 GFLOP at B=4096, about
// 0.14 ms of the H100's non-tensor FP32 rate; the operands and outputs are
// ~13 KB per scenario, ~0.016 ms at 3.35 TB/s.  But the work is a chain:
// 40 sweeps x 2h dependent steps, each a few 13-long FMA chains.  The
// first version ran one thread per scenario with the factors (19 KB per
// scenario) in a device-memory scratch: 64 blocks of 64 threads for 132
// SMs, ~30 ms at B=4096, bound by latency, not by memory traffic or
// operations (PERF.md).
//
// This design shortens the chain and puts every scenario's data on chip:
// - one group of 16 lanes (half a warp) per scenario, 8 scenarios per
//   block: lane i < 13 owns row i of the 13-row objects (P, PA, A^T P A, x,
//   p), lane i < 12 row i of the 12-row ones ([M | I], G, K, M^-1, m, d,
//   u~), and lane r the cone rows r and r+16 of a step.  A lane computes its
//   row of a product as independent fmaf chains held in registers; its row
//   of [M | I] stays in registers through the Gauss-Jordan (pivot rows go
//   through shared memory); through the sweeps it holds its rows and
//   columns of Ad and Bd in registers, so a sweep step is one to three
//   13-long chains per lane on operands read from shared memory, the
//   broadcast vectors (p, x, m, mask u~) 16 bytes at a time.  Vectors pass
//   between lanes through shared memory, with a warp barrier between
//   dependent phases;
// - per scenario, shared memory holds the sweep's vectors (112 floats), Ad
//   and Bd (338), the factors K_k and M_k^-1 (300 h), the per-step
//   operands on the sweeps' chains mask, qx and gate (45 h; read from L2
//   in every sweep they cost ~12%, PERF.md), and the iteration state u, z,
//   y, d (64 h, the same region as the factorization's work matrices
//   before): 7,024 floats, 28,096 B at h=16, so a block of 8 fills the 227
//   KB a block may use, 8 scenarios are resident per SM and B=4096 runs in
//   3.9 waves.  No device-memory scratch.  hu (factorization only) and the
//   clip bounds lo, hi (no chain waits on them) are read from L2; U and Y
//   are written once, at the end;
// - operands are batch-major, (B, rows): a scenario's rows are contiguous,
//   so a group's 16 lanes read neighbouring floats.
// FP32 FMA only: the 13 x 13 products are too small for tensor cores, and
// TF32 is not exact enough.  A group past a ragged batch's end runs on a
// clamped scenario, reaches every barrier, and stores nothing.
#include <cuda_runtime.h>

#include "riccati_admm.cuh"

namespace {

constexpr int kLanes = 16;
// Scenarios per block: 8 fill one block's 227 KB at h=16 (28 KB each), the
// most an SM holds.  Fewer, in pairs, where 8 do not fit.
constexpr int kGroups = 8;

__global__ void __launch_bounds__(kLanes * kGroups) riccati_admm_kernel(riccati_admm::Operands o) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / kLanes;
  const long long b = (long long)blockIdx.x * (blockDim.x / kLanes) + g;
  const riccati_admm::Team<kLanes> t{(int)threadIdx.x % kLanes};
  riccati_admm::solve_one(t, o, b < o.B ? b : o.B - 1,
                          smem + g * riccati_admm::group_floats(o.h), b < o.B);
}

// Scenarios per block at horizon h: an even number (whole warps), 0 when
// not even two fit.
int block_groups(int h) {
  const long long fit = riccati_admm::SMEM_LIMIT / (4 * riccati_admm::group_floats(h));
  return (int)(fit < kGroups ? fit : kGroups) & ~1;
}

cudaError_t prepare(int groups, int h, size_t* smem) {
  *smem = (size_t)groups * 4 * riccati_admm::group_floats(h);
  return cudaFuncSetAttribute(riccati_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" int riccati_admm_launch(
    const float* A, const float* Bd, const float* hu, const float* mask,
    const float* q2, const float* mu, const float* rho, const float* qx,
    const float* xt, const float* gate, const float* lo, const float* hi,
    const float* u0, const float* z0, const float* y0, float* U, float* Y,
    int B, int h, int iterations, float sigma, float alpha, void* stream) {
  const int groups = block_groups(h);
  if (groups == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  size_t smem = 0;
  const cudaError_t e = prepare(groups, h, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  riccati_admm::Operands o{A, Bd, hu, mask, q2, mu, rho, qx, xt, gate, lo, hi,
                           u0, z0, y0, U, Y, B, h, iterations, sigma, alpha};
  const int blocks = (B + groups - 1) / groups;
  riccati_admm_kernel<<<blocks, kLanes * groups, smem, static_cast<cudaStream_t>(stream)>>>(o);
  return static_cast<int>(cudaGetLastError());
}

// out[0] resident scenarios per SM, out[1] dynamic shared memory bytes per
// block, out[2] scenarios per block, at horizon h.
extern "C" int riccati_admm_occupancy(int h, int* out) {
  const int groups = block_groups(h);
  if (groups == 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t e = prepare(groups, h, &smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, riccati_admm_kernel,
                                                      kLanes * groups, smem);
  out[0] = blocks * groups;
  out[1] = (int)smem;
  out[2] = groups;
  return static_cast<int>(e);
}
