// The condensed-ADMM invert kernel on Hopper (sm_90a): one thread block of
// 512 threads per scenario.  The arithmetic lives in admm.cuh; this file
// holds the kernel and its C launcher, bound from Python with ctypes
// (pympc_quadruped_tpu_torch/ops/qp/admm_cuda.py).  The other three
// condensed kernels have translation units of their own: the iterate
// kernel admm_iterate.cu, the fused and full kernels admm_fused.cu, which
// run this kernel's inverse inside them.
//
// They replace the TPU kernels of pympc_quadruped_tpu/ops/qp/admm_pallas.py:
//   admm_invert_kernel   <- _invert_kernel (:242, wrapper invert_spd :266)
//   admm_iterate_kernel  <- _kernel (:38, wrapper _iterate :81), admm_iterate.cu
//   admm_fused_kernel    <- _fused_kernel (:374, wrapper _iterate_fused :647), admm_fused.cu
//   admm_full_kernel     <- _full_kernel (:417, wrapper _solve_full :533), admm_fused.cu
// The Pallas kernels put a tile of scenarios on the grid and padded n to a
// power of two (192 -> 256) and B to a Mosaic-legal tile; these kernels take
// any n = 12h and any B, split the recursion at n/2 (192 -> 96 -> 48 -> 24
// -> 12), and mask their own ragged tiles.
//
// What bounds it on the H100 (reckoned from the code at B = 4096, h = 16,
// n = 192; the measured times are in PERF.md): ~38 MFLOP per scenario (the
// recursion ~4/3 n^3, one Newton-Schulz step 4 n^3), ~155 GFLOP in all,
// ~2.3 ms at the 67 TFLOP/s FP32 rate, against 1.2 GB of K and Kinv, ~0.37
// ms at 3.35 TB/s: bound by operations.  But the recursion is a chain of
// hundreds of small dependent steps (16 Gauss-Jordan leaves of 12 pivots,
// four products a level), so what bounds it is each step's latency.  The
// kernel keeps every operand of the recursion in shared memory: it inverts
// X = sym(K) in place in one n x (n+1) buffer (148 KB at h = 16) and reads
// K from device memory once.  The recursion's products read their operands
// where they lie, with no tile copies and one barrier each, on a 32 x 16
// grid of lanes whose micro-tiles are sized to the product.  The
// Newton-Schulz step runs by 64-column panels T = 2I - K X[:, J] (48 KB, on
// chip), each lane computing 6 x 4 outputs of a 192-row panel; it writes
// R[:, J] = X T straight to Kinv and then symmetrizes Kinv in place by tile
// pairs while it is hot in L2; no device-memory workspace.  With the 17 KB
// of tiles a block takes 210 KB: one block of 512 threads per SM.  FP32
// FMA only: no TF32 or bf16 tensor-core products, whose rounding
// NaN-poisons the recursion (admm_pallas.py:114).  From h = 17 the buffer
// does not fit, and the same code runs on it in a device-memory workspace.
#include <cuda_runtime.h>

#include "admm.cuh"

namespace {

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

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename F>
cudaError_t launch_prep(F* kernel, long long smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

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
