// The condensed QP's operands on Hopper (sm_90a): one thread block of 256
// threads per scenario builds the masked (H, g) that
// cones.mask_cost(*condense.condense(...), mv) returns
// (pympc_quadruped_tpu_torch/ops/condense.py, ops/qp/cones.py).  The
// arithmetic lives in condense.cuh; this file holds the kernel and its C
// launcher, bound from Python with ctypes
// (pympc_quadruped_tpu_torch/ops/qp/admm_cuda.py, condense).
//
// It replaces no TPU kernel: the JAX package condenses in plain XLA
// (pympc_quadruped_tpu/ops/condense.py), and the port's plain version
// builds Su (B, 13h, 12h) by a gather, a mask and a permuted copy, scales
// it, and forms H by a (B,12h,13h) x (B,13h,12h) Gram product: at B = 4096
// and h = 16, ~10-12 GB of device traffic and 63 GFLOP, mostly over
// Su's structural zeros.
//
// What bounds it (B = 4096, h = 16, n = 192): the output, H, 604 MB, ~0.18
// ms at 3.35 TB/s; the inputs are ~3 KB a scenario.  The distinct work is
// h(h+1)/2 = 136 products of 12 x 13 by 13 x 12 (~0.25 MFMA a scenario,
// ~2.1 GFLOP in all, ~0.03 ms at 67 TFLOP/s): bound by the bytes written.
// So the kernel keeps everything but H and g on chip, and writes H once:
// - M_k = Ad^k Bd, W_k = sqrt(Q) M_k (k < h) and the free trajectory
//   x_{k+1} = Ad x_k are built in shared memory, h dependent steps of
//   13-long FMA chains, one barrier each;
// - the h(h+1)/2 blocks S(d, e) of Su^T Qbar Su's upper triangle, running
//   sums over the Toeplitz diagonal d, go to shared memory (78 KB at h =
//   16), each lane accumulating a 4 x 4 tile in registers over its run of
//   e, operands read 16 bytes at a time; g's 12h sums in the same pass;
// - then the block writes H row after row, 16 bytes a lane with streaming
//   stores, each float4 from one S block (its mirror's transpose below the
//   diagonal), doubled, the R ridge on the diagonal and the swing mask
//   applied on the way out.
// Shared memory: 92.7 KB a block at h = 16 (two blocks resident per SM),
// 41.7 KB at h = 10 (three, at 78 registers a thread); the plan covers h <=
// condense::MAX_H = 18 (114 KB, still two blocks), and the launcher refuses
// a longer horizon.
// FP32 FMA only: no TF32 or bf16 tensor-core products.  The kernel
// allocates nothing and never synchronises with the host.
#include <cuda_runtime.h>

#include "condense.cuh"

namespace {

// 256 threads a block: 512 ran the kernel 16% slower at h = 16 (PERF.md).
// Three blocks an SM cap a thread at 85 registers (78 used, no spills), so
// three blocks fit at h = 10; a cap of 64 (four blocks) spilled and ran h =
// 16 6% slower.
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 3) condense_kernel(condense::Args a, int h) {
  extern __shared__ __align__(16) float smem[];
  const condense::Team<kThreads> t{(int)threadIdx.x};
  condense::condense_one(t, condense::scenario_args(a, blockIdx.x, h), smem, h);
}

cudaError_t prepare(int h, long long* smem) {
  *smem = 4 * condense::smem_floats(h);
  if (*smem > condense::SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(condense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" int condense_max_horizon() { return condense::MAX_H; }

extern "C" int condense_launch(const float* Ad, const float* Bd, const float* x_t,
                               const float* X_ref, const float* mv, const float* q,
                               const float* r, float* H, float* g, int B, int h,
                               void* stream) {
  if (h < 1 || h > condense::MAX_H) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  long long smem = 0;
  const cudaError_t e = prepare(h, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const condense::Args a{Ad, Bd, x_t, X_ref, mv, q, r, H, g};
  condense_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, h);
  return static_cast<int>(cudaGetLastError());
}

// out[0] blocks (scenarios) resident per SM, out[1] dynamic shared memory
// bytes per block, at horizon h.
extern "C" int condense_occupancy(int h, int* out) {
  long long smem = 0;
  cudaError_t e = prepare(h, &smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, condense_kernel, kThreads, smem);
  out[0] = blocks;
  out[1] = (int)smem;
  return static_cast<int>(e);
}
