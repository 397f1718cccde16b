// One-thread stamp of the card's clock, for the traced replay of the closed
// loop's non-solve tick (pympc_quadruped_tpu_torch/utils/profiling.py).
//
// It replaces no TPU kernel: the JAX package traces its loop with
// jax.profiler only.  The traced graph (env/graph_loop.py) holds one launch
// at each span's entry and exit; each writes %globaltimer (ns) into
// stamps[row * width + slot], row the tick's row of the loop's metric rows.
// The tick's first stamp (latch) reads the device tick and keeps the row in
// *row for the later ones, since the tick advances before the last span
// ends.  Nodes of one captured stream run in order, so a row's stamps are
// ordered as its spans' ends.  What bounds it: one launch a node (~2 us in
// a graph), nothing of memory or arithmetic.  A row outside [0, num_ticks)
// or a slot outside [0, width) writes nothing.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(const int* tick, int tick0, int* row, int latch,
                             long long* stamps, int num_ticks, int width, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int r = latch ? *tick - tick0 : *row;
  if (latch) *row = r;
  if (r >= 0 && r < num_ticks && slot >= 0 && slot < width)
    stamps[static_cast<long long>(r) * width + slot] = static_cast<long long>(now);
}

}  // namespace

extern "C" int stamp_launch(const int* tick, int tick0, int* row, int latch,
                            long long* stamps, int num_ticks, int width, int slot,
                            void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(tick, tick0, row, latch, stamps,
                                                                num_ticks, width, slot);
  return static_cast<int>(cudaGetLastError());
}
