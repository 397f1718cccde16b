// The condensed-ADMM iterate kernel on Hopper (sm_90a): admm_iterate_kernel
// replaces _kernel of pympc_quadruped_tpu/ops/qp/admm_pallas.py (:38,
// wrapper _iterate :81), the second stage of the default `pallas_split`
// solve.  The arithmetic lives in admm.cuh (iterate_resident, iterate_one);
// this file holds the kernels and their C launchers, bound from Python with
// ctypes (pympc_quadruped_tpu_torch/ops/qp/admm_cuda.py).  It is a
// translation unit of its own, so that it builds in seconds beside admm.cu.
//
// What bounds it on the H100 (B = 4096, h = 16, n = 192, m = 320, 40
// sweeps): per sweep one n x n matrix-vector product (2 n^2 flop) and O(m)
// cone work, 13.3 GFLOP in all, ~0.198 ms at the 67 TFLOP/s FP32 rate,
// against 653 MB of Kinv and vectors read once and x, y written once,
// ~0.195 ms at 3.35 TB/s: balanced between the two.  The sweeps are a chain
// of 40 dependent products per scenario, so what the design fights is
// latency and shared-memory traffic:
// - Kinv in registers.  A block of 384 threads (12 warps) holds one
//   scenario's Kinv for all its sweeps: warp w rows [16w, 16w + 16), lane j
//   the columns j + 32c (c < 6), 96 floats a lane.  A sweep's product is 16
//   independent 6-term fmaf chains a lane on 6 conflict-free reads of rhs,
//   then a reduce-scatter butterfly of 16 shuffles; the order is admm.cuh's
//   row_times, so the result does not depend on the lane split.
// - Persistent blocks, one per SM (grid min(B, SMs)), each walking
//   scenarios b, b + grid, ...  One thread starts bulk copies (TMA,
//   cp.async.bulk on an mbarrier) of the next scenario's Kinv (147,456 B)
//   and nine vectors into a shared-memory stage as soon as the current
//   scenario has moved to registers, so Kinv is read from device memory
//   once, behind the previous scenario's sweeps.  The block takes 168,976 B
//   of shared memory.
// - For n > 192 (h > 16) the tile does not fit in registers, and
//   admm_iterate_wide_kernel runs one 256-thread block per scenario with
//   Kinv in shared memory (ld n + 1) to h = 19, read from device memory
//   from h = 20, in the same summation order.
#include <cuda_runtime.h>

#include "admm.cuh"

namespace {

__global__ void __launch_bounds__(admm::RES_THREADS, 1)
admm_iterate_kernel(const float* Kinv, admm::IterArgs a, const float* P0, long long B, int n,
                    int m, int iterations, float sigma, float alpha) {
  extern __shared__ __align__(16) float smem[];
  admm::iterate_resident(admm::Team<admm::RES_THREADS>{(int)threadIdx.x}, Kinv, a, B, n, m,
                         P0[2], iterations, sigma, alpha, blockIdx.x, gridDim.x, smem);
}

constexpr int kWideThreads = 256;

__global__ void __launch_bounds__(kWideThreads)
admm_iterate_wide_kernel(const float* Kinv, admm::IterArgs a, const float* P0, int n, int m,
                         int iterations, float sigma, float alpha, int kinv_on_chip) {
  extern __shared__ __align__(16) float smem[];
  const admm::Team<kWideThreads> t{(int)threadIdx.x};
  const long long b = blockIdx.x;
  float* kinv = kinv_on_chip ? smem : nullptr;
  float* vecs = kinv_on_chip ? smem + admm::x_floats(n) : smem;
  admm::iterate_one(t, Kinv + b * n * n, kinv, admm::scenario_args(a, b, n, m), n, m, P0[2],
                    iterations, sigma, alpha, vecs);
}

// The launch of either kernel at (B, n, m), its shared memory opted in.
struct Launch {
  int threads, grid;
  long long smem;
};

cudaError_t plan(int B, int n, int m, Launch& l) {
  l.smem = admm::smem_bytes(admm::ITERATE, n, m);
  if (!admm::in_registers(n)) {
    l.threads = kWideThreads;
    l.grid = B;
    return cudaFuncSetAttribute(admm_iterate_wide_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admm_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)l.smem);
  l.threads = admm::RES_THREADS;
  l.grid = B < sms ? B : sms;
  return err;
}

}  // namespace

extern "C" int admm_iterate_launch(const float* Kinv, const float* q, const float* d,
                                   const float* es, const float* rho, const float* l,
                                   const float* u, const float* P0, const float* x0,
                                   const float* z0, const float* y0, float* x, float* y,
                                   int B, int n, int m, int iterations, float sigma,
                                   float alpha, void* stream) {
  if (B == 0) return 0;
  Launch p;
  cudaError_t err = plan(B, n, m, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const admm::IterArgs a{q, d, es, rho, l, u, x0, z0, y0, x, y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (admm::in_registers(n))
    admm_iterate_kernel<<<p.grid, p.threads, p.smem, s>>>(Kinv, a, P0, B, n, m, iterations,
                                                          sigma, alpha);
  else
    admm_iterate_wide_kernel<<<p.grid, p.threads, p.smem, s>>>(
        Kinv, a, P0, n, m, iterations, sigma, alpha, admm::on_chip(admm::ITERATE, n, m));
  return static_cast<int>(cudaGetLastError());
}

// How the iterate kernel launches at (B, n, m): out[0] threads a block,
// out[1] blocks, out[2] dynamic shared memory bytes a block, out[3] blocks
// resident per SM.
extern "C" int admm_iterate_config(int B, int n, int m, int* out) {
  Launch p;
  cudaError_t err = plan(B, n, m, p);
  int resident = 0;
  if (err == cudaSuccess)
    err = admm::in_registers(n)
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, admm_iterate_kernel,
                                                        p.threads, p.smem)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, admm_iterate_wide_kernel,
                                                        p.threads, p.smem);
  out[0] = p.threads;
  out[1] = p.grid;
  out[2] = (int)p.smem;
  out[3] = resident;
  return static_cast<int>(err);
}
