// Host build of the controller's tick kernels: the same C launchers as
// ctrl_tick.cu, one robot after another on the CPU, each robot's rows read
// and written in place (the card stages them through shared memory).  The
// CPU tests compile it with the host C++ compiler and drive it through the
// same ctypes binding as the CUDA library, so the kernels' own per-robot
// code (ctrl_tick.cuh) is checked against the plain PyTorch functions and
// the JAX reference without a card.
#include "ctrl_tick.cuh"

namespace {

using namespace ctrl_tick;

// Robot b's rows: input f at in[f] + b * stride[f], output f at out[f] +
// b * width(f).
template <int NI, int NO, class Width, class Run>
int each_robot(const void* const* in, const long long* stride, void* const* out, long long B,
               Width width, Run run) {
  for (long long b = 0; b < B; ++b) {
    const float* rin[NI];
    float* rout[NO];
    for (int f = 0; f < NI; ++f) rin[f] = static_cast<const float*>(in[f]) + b * stride[f];
    for (int f = 0; f < NO; ++f) rout[f] = static_cast<float*>(out[f]) + b * width(f);
    run(rin, rout, b);
  }
  return 0;
}

}  // namespace

extern "C" int srb_observe_launch(const void* const* in, const long long* stride,
                                  void* const* out, float cos_knee_max, long long B,
                                  void* /*stream*/) {
  const ObserveArgs a{cos_knee_max};
  return each_robot<obs::NI, obs::NO>(
      in, stride, out, B, [](int f) { return obs::out_width(f, 0); },
      [&](const float* const* rin, float* const* rout, long long) { srb_observe_one(rin, rout, a); });
}

extern "C" int ctrl_pre_launch(const void* const* in, const long long* stride, void* const* out,
                               const int* num_segments, const int* stance_offsets,
                               const int* stance_durations, const unsigned char* first_run,
                               unsigned char* first_run_out, const float* dt,
                               const float* gravity, const int* tick_dev, int tick, int h,
                               int iters, long long B, void* /*stream*/) {
  if (h < 1 || iters < 1) return 1;  // cudaErrorInvalidValue
  const PreArgs a{num_segments, stance_offsets, stance_durations, first_run, first_run_out,
                  dt, gravity, tick_dev, tick, h, iters};
  return each_robot<pre::NI, pre::NO>(
      in, stride, out, B, [h](int f) { return pre::out_width(f, h); },
      [&](const float* const* rin, float* const* rout, long long b) {
        ctrl_pre_one(rin, rout, a, b);
      });
}

extern "C" int ctrl_post_launch(const void* const* in, const long long* stride,
                                void* const* out, const int* num_segments,
                                const int* stance_durations, const unsigned char* is_first,
                                unsigned char* is_first_out, const float* dt,
                                const float* gravity, int iters, int ground_adaptive,
                                long long B, void* /*stream*/) {
  if (iters < 1) return 1;  // cudaErrorInvalidValue
  const PostArgs a{num_segments, stance_durations, is_first, is_first_out, dt, gravity, iters,
                   ground_adaptive};
  return each_robot<post::NI, post::NO>(
      in, stride, out, B, [](int f) { return post::out_width(f, 0); },
      [&](const float* const* rin, float* const* rout, long long b) {
        ctrl_post_one(rin, rout, a, b);
      });
}
