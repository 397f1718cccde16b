// The controller's per-robot tick on Hopper (sm_90a): three kernels,
// srb_observe, ctrl_pre and ctrl_post, whose arithmetic lives in
// ctrl_tick.cuh; this file holds the kernels and their C launchers, bound
// from Python with ctypes (pympc_quadruped_tpu_torch/control/ctrl_cuda.py).
//
// They replace no TPU kernel: the JAX package leaves this code to XLA's
// fusion.  The port's plain versions (env/srb_env.observe,
// control/controller._pre_solve and _post_solve) are ~690 PyTorch calls a
// tick, ~490 kernel nodes of each replayed graph at ~1.8 us a node.
//
// What bounds them (B = 4096, h = 16): the bytes, ~0.9 / 1.6 / 1.5 MB
// (observe / pre / post), ~0.3-0.5 us each at 3.35 TB/s; the arithmetic is
// a few hundred flops and ~30 sines, cosines and arctangents a robot.  So
// one thread computes one robot, a block of kRows robots: the block brings
// each float field's rows (contiguous, or rows of a wider tensor) into
// shared memory with consecutive threads on consecutive floats, computes,
// and writes each output field back the same way.  A row sits in shared
// memory at an odd stride (its width rounded up to odd), so the threads of
// a warp reading their robots' k-th floats hit 32 different banks.  The
// gait's int32 rows and the one-byte flags are read and written in place
// (one to four values a robot, consecutive across the warp).
// FP32 with FMA, no fast-math; nothing allocated, no host synchronisation.
#include <cuda_runtime.h>

#include "ctrl_tick.cuh"

namespace {

using namespace ctrl_tick;

// Robots (threads) a block: 4096 robots fill 128 blocks, about one an SM.
constexpr int kRows = 32;
constexpr int kStaticSmem = 48 * 1024;

template <int NI, int NO>
struct Io {
  const float* in[NI];
  long long stride[NI];  // floats between consecutive rows
  float* out[NO];        // contiguous (B, width)
};

__host__ __device__ constexpr int odd(int w) { return w | 1; }

template <class K>
__host__ __device__ constexpr int smem_floats(int h) {
  int n = 0;
  for (int f = 0; f < K::NI; ++f) n += kRows * odd(K::in_width(f, h));
  for (int f = 0; f < K::NO; ++f) n += kRows * odd(K::out_width(f, h));
  return n;
}

// The three kernels' fields and bodies, for the one template below.
struct Observe {
  static constexpr int NI = obs::NI, NO = obs::NO;
  using Args = ObserveArgs;
  __host__ __device__ static constexpr int in_width(int f, int h) { return obs::in_width(f, h); }
  __host__ __device__ static constexpr int out_width(int f, int h) { return obs::out_width(f, h); }
  __device__ static int horizon(const Args&) { return 0; }
  __device__ static void run(const float* const* in, float* const* out, const Args& a,
                             long long) {
    srb_observe_one(in, out, a);
  }
};

struct Pre {
  static constexpr int NI = pre::NI, NO = pre::NO;
  using Args = PreArgs;
  __host__ __device__ static constexpr int in_width(int f, int h) { return pre::in_width(f, h); }
  __host__ __device__ static constexpr int out_width(int f, int h) { return pre::out_width(f, h); }
  __device__ static int horizon(const Args& a) { return a.h; }
  __device__ static void run(const float* const* in, float* const* out, const Args& a,
                             long long b) {
    ctrl_pre_one(in, out, a, b);
  }
};

struct Post {
  static constexpr int NI = post::NI, NO = post::NO;
  using Args = PostArgs;
  __host__ __device__ static constexpr int in_width(int f, int h) { return post::in_width(f, h); }
  __host__ __device__ static constexpr int out_width(int f, int h) { return post::out_width(f, h); }
  __device__ static int horizon(const Args&) { return 0; }
  __device__ static void run(const float* const* in, float* const* out, const Args& a,
                             long long b) {
    ctrl_post_one(in, out, a, b);
  }
};

template <class K>
__global__ void __launch_bounds__(kRows) tick_kernel(Io<K::NI, K::NO> io, typename K::Args a,
                                                     long long B) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * kRows;
  const int nb = (int)(B - b0 < kRows ? B - b0 : kRows);
  const int h = K::horizon(a);
  const float* in[K::NI];
  float* out[K::NO];
  float* s = smem;
#pragma unroll
  for (int f = 0; f < K::NI; ++f) {
    const int w = K::in_width(f, h), wp = odd(w);
    const float* src = io.in[f];
    const long long stride = io.stride[f];
    for (int i = t; i < nb * w; i += kRows) {
      const int r = i / w, c = i - r * w;
      s[r * wp + c] = src[(b0 + r) * stride + c];
    }
    in[f] = s + t * wp;
    s += kRows * wp;
  }
#pragma unroll
  for (int f = 0; f < K::NO; ++f) {
    out[f] = s + t * odd(K::out_width(f, h));
    s += kRows * odd(K::out_width(f, h));
  }
  __syncthreads();
  if (t < nb) K::run(in, out, a, b0 + t);
  __syncthreads();
#pragma unroll
  for (int f = 0; f < K::NO; ++f) {
    const int w = K::out_width(f, h), wp = odd(w);
    const float* row0 = out[f] - t * wp;
    float* dst = io.out[f] + b0 * w;
    for (int i = t; i < nb * w; i += kRows) {
      const int r = i / w, c = i - r * w;
      dst[i] = row0[r * wp + c];
    }
  }
}

template <class K>
int launch(const void* const* in, const long long* stride, void* const* out,
           const typename K::Args& a, int h, long long B, void* stream) {
  if (B <= 0) return 0;
  Io<K::NI, K::NO> io;
  for (int f = 0; f < K::NI; ++f) {
    io.in[f] = static_cast<const float*>(in[f]);
    io.stride[f] = stride[f];
  }
  for (int f = 0; f < K::NO; ++f) io.out[f] = static_cast<float*>(out[f]);
  const int smem = 4 * smem_floats<K>(h);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        tick_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (B + kRows - 1) / kRows;
  tick_kernel<K><<<(unsigned)blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(io, a, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srb_observe_launch(const void* const* in, const long long* stride,
                                  void* const* out, float cos_knee_max, long long B,
                                  void* stream) {
  const ObserveArgs a{cos_knee_max};
  return launch<Observe>(in, stride, out, a, 0, B, stream);
}

extern "C" int ctrl_pre_launch(const void* const* in, const long long* stride, void* const* out,
                               const int* num_segments, const int* stance_offsets,
                               const int* stance_durations, const unsigned char* first_run,
                               unsigned char* first_run_out, const float* dt,
                               const float* gravity, const int* tick_dev, int tick, int h,
                               int iters, long long B, void* stream) {
  if (h < 1 || iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PreArgs a{num_segments, stance_offsets, stance_durations, first_run, first_run_out,
                  dt, gravity, tick_dev, tick, h, iters};
  return launch<Pre>(in, stride, out, a, h, B, stream);
}

extern "C" int ctrl_post_launch(const void* const* in, const long long* stride,
                                void* const* out, const int* num_segments,
                                const int* stance_durations, const unsigned char* is_first,
                                unsigned char* is_first_out, const float* dt,
                                const float* gravity, int iters, int ground_adaptive,
                                long long B, void* stream) {
  if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PostArgs a{num_segments, stance_durations, is_first, is_first_out, dt, gravity, iters,
                   ground_adaptive};
  return launch<Post>(in, stride, out, a, 0, B, stream);
}
