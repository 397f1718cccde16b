// Per-robot arithmetic of the controller's tick kernels (ctrl_tick.cu): the
// closed-form parts of one 1 kHz tick that run on every tick, solve or not.
//
//   srb_observe  env/srb_env.observe: the joint angles and rates that the
//                rigid-body plant's state implies (rotation, the leg's
//                closed-form IK, FK and Jacobian, a 3x3 solve for qdot);
//   ctrl_pre     control/controller._pre_solve: the KinState of
//                ops/kin.compute_kin_state (with the Pinocchio velocity
//                quirk), the swing phases and the (4h) stance table of
//                ops/gaitsched, the MPC state x_t, and
//                refmpc.integrate_desired's carry and world velocity;
//   ctrl_post    control/controller._post_solve: swing.update_swing's new
//                latches and targets, and legctrl.leg_torques.
//
// The JAX package leaves this code to XLA's fusion and the port's plain
// versions run it op by op (~690 PyTorch calls a tick); each robot's work
// is a few hundred flops on ~100 floats in and ~250 out, so one thread
// computes one robot.  The functions here take one robot's rows as
// pointers, `in[f]` / `out[f]` for the fields numbered by each kernel's
// enums, and its integer and boolean fields by index; ctrl_tick.cu points
// them at shared memory, where a block stages its robots' rows with
// coalesced loads and stores, and ctrl_tick_host.cpp at the tensors
// themselves.  The code is plain C++ marked __host__ __device__, so a host
// compiler runs the same arithmetic on the CPU.
//
// Each output follows its plain counterpart's operations in order, in FP32
// (the card contracts a product and a sum into an FMA, so the two agree to
// a few ulps, not bit for bit); sinf, cosf, atan2f, asinf, acosf and sqrtf
// in their accurate forms, no fast-math.  The clamps and maxima propagate
// NaN, as torch.clamp and torch.maximum do, so a diverged robot stays its
// own.
#pragma once

#ifndef __CUDACC__
#include <math.h>
#define __host__
#define __device__
#endif
#include <stdint.h>

namespace ctrl_tick {

// ---- fields: each kernel's float rows, in the order the launcher takes
// their pointers, and each row's width in floats ----

namespace obs {
enum In { POS, QUAT, VEL, OMEGA, FOOT_POS, FOOT_VEL, HIP_OFFSET, HIP_LEN, L_THIGH, L_CALF, NI };
enum Out { Q, QDOT, NO };
__host__ __device__ constexpr int in_width(int f, int /*h*/) {
  return f == QUAT ? 4 : f == FOOT_POS || f == FOOT_VEL || f == HIP_OFFSET ? 12
         : f == HIP_LEN ? 4 : f == L_THIGH || f == L_CALF ? 1 : 3;
}
__host__ __device__ constexpr int out_width(int /*f*/, int /*h*/) { return 12; }
}  // namespace obs

namespace pre {
enum In { QUAT, POS, VEL, OMEGA, Q, QDOT, HIP_OFFSET, HIP_LEN, L_THIGH, L_CALF, VEL_DES,
          YAW_RATE, XPOS_DES, YPOS_DES, NI };
enum Out { R, RPY, P_BF, POS_BASE_FEET, POS_FEET, VEL_BF, THIGHS, JAC, SWING_STATES, TABLE,
           X_T, XPOS_OUT, YPOS_OUT, YAW_OUT, VEL_DES_WORLD, NO };
__host__ __device__ constexpr int in_width(int f, int /*h*/) {
  return f == QUAT ? 4 : f == Q || f == QDOT || f == HIP_OFFSET ? 12 : f == HIP_LEN ? 4
         : f == L_THIGH || f == L_CALF || f == YAW_RATE || f == XPOS_DES || f == YPOS_DES ? 1
         : 3;
}
__host__ __device__ constexpr int out_width(int f, int h) {
  return f == R ? 9 : f == RPY || f == VEL_DES_WORLD ? 3 : f == JAC ? 36
         : f == SWING_STATES ? 4 : f == TABLE ? 4 * h : f == X_T ? 13
         : f == XPOS_OUT || f == YPOS_OUT || f == YAW_OUT ? 1 : 12;
}
}  // namespace pre

namespace post {
enum In { R, POS, VEL, POS_FEET, THIGHS, P_BF, VEL_BF, JAC, REMAINING, FOOT_INIT, FOOT_FINAL,
          SWING_STATES, FORCES, VEL_DES, YAW_RATE, KP, KD, TOUCHDOWN_Z, SWING_HEIGHT, NI };
enum Out { REMAINING_OUT, FOOT_INIT_OUT, FOOT_FINAL_OUT, POS_TARGETS, VEL_TARGETS, TORQUES,
           NO };
__host__ __device__ constexpr int in_width(int f, int /*h*/) {
  return f == R ? 9 : f == JAC ? 36 : f == REMAINING || f == SWING_STATES ? 4
         : f == POS || f == VEL || f == VEL_DES || f == KP || f == KD ? 3
         : f == YAW_RATE || f == TOUCHDOWN_Z || f == SWING_HEIGHT ? 1 : 12;
}
__host__ __device__ constexpr int out_width(int f, int /*h*/) {
  return f == REMAINING_OUT ? 4 : 12;
}
}  // namespace post

// The integer, boolean and shared operands of each kernel.  Gaits are
// int32 rows (num_segments (B), offsets and durations (B, 4)); flags are
// one byte a value; dt and gravity are 0-d device tensors, read by every
// thread; the tick is read from `tick_dev` when it is set (the loop's
// device tick, which a replayed graph advances), else it is `tick`.
struct ObserveArgs {
  float cos_knee_max;  // kin._COS_KNEE_MAX: the knee stops 0.1 rad short of straight
};

struct PreArgs {
  const int32_t *num_segments, *stance_offsets, *stance_durations;
  const uint8_t* first_run;
  uint8_t* first_run_out;
  const float *dt, *gravity;
  const int32_t* tick_dev;
  int tick, h, iters;
};

struct PostArgs {
  const int32_t *num_segments, *stance_durations;
  const uint8_t* is_first;
  uint8_t* is_first_out;
  const float *dt, *gravity;
  int iters, ground_adaptive;
};

// ---- scalar helpers with torch's NaN behaviour ----

__host__ __device__ inline float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__host__ __device__ inline float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__host__ __device__ inline float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? b : a));
}
// Python's floor division and modulo on ints (torch's // and remainder).
__host__ __device__ inline int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__host__ __device__ inline int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// ---- 3-vectors and 3x3 matrices (row-major) ----

// lie.quat_to_rotmat: the unnormalized Hamilton form of a wxyz quaternion.
__host__ __device__ inline void quat_to_rotmat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  R[0] = ww + xx - yy - zz;
  R[1] = 2.0f * (x * y - w * z);
  R[2] = 2.0f * (w * y + x * z);
  R[3] = 2.0f * (w * z + x * y);
  R[4] = ww - xx + yy - zz;
  R[5] = 2.0f * (y * z - w * x);
  R[6] = 2.0f * (x * z - w * y);
  R[7] = 2.0f * (w * x + y * z);
  R[8] = ww - xx - yy + zz;
}

// lie.quat_to_zyx: [roll, pitch, yaw].
__host__ __device__ inline void quat_to_zyx(const float* q, float* rpy) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  rpy[0] = atan2f(2.0f * (w * x + y * z), 1.0f - 2.0f * (x * x + y * y));
  rpy[1] = asinf(clamp(2.0f * (w * y - z * x), -1.0f, 1.0f));
  rpy[2] = atan2f(2.0f * (w * z + x * y), 1.0f - 2.0f * (y * y + z * z));
}

// y = R v.
__host__ __device__ inline void mat_vec(const float* R, const float* v, float* y) {
  for (int i = 0; i < 3; ++i) y[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

// y = v R (row vector times R: y_j = sum_i v_i R_ij), i.e. R^T v.
__host__ __device__ inline void vec_mat(const float* v, const float* R, float* y) {
  for (int j = 0; j < 3; ++j) y[j] = v[0] * R[j] + v[1] * R[3 + j] + v[2] * R[6 + j];
}

// torch.linalg.cross(a, b).
__host__ __device__ inline void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// lie.solve3: A x = b by the adjugate.
__host__ __device__ inline void solve3(const float* A, const float* b, float* x) {
  const float a00 = A[0], a01 = A[1], a02 = A[2];
  const float a10 = A[3], a11 = A[4], a12 = A[5];
  const float a20 = A[6], a21 = A[7], a22 = A[8];
  const float c00 = a11 * a22 - a12 * a21;
  const float c01 = a12 * a20 - a10 * a22;
  const float c02 = a10 * a21 - a11 * a20;
  const float det = a00 * c00 + a01 * c01 + a02 * c02;
  const float c10 = a02 * a21 - a01 * a22;
  const float c11 = a00 * a22 - a02 * a20;
  const float c12 = a01 * a20 - a00 * a21;
  const float c20 = a01 * a12 - a02 * a11;
  const float c21 = a02 * a10 - a00 * a12;
  const float c22 = a00 * a11 - a01 * a10;
  const float inv_det = 1.0f / det;
  x[0] = (c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det;
  x[1] = (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det;
  x[2] = (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det;
}

// ---- one leg (ops/kin.py) ----

// kin.leg_forward_kinematics: base-frame foot p and Jacobian J (row i of
// the foot's coordinates, column c of d/dq_c) of joint angles q.
__host__ __device__ inline void leg_fk(const float* q, const float* hip, float s, float l2,
                                       float l3, float* p, float* J) {
  const float c1 = cosf(q[0]), s1 = sinf(q[0]);
  const float c2 = cosf(q[1]), s2 = sinf(q[1]);
  const float q23 = q[1] + q[2];
  const float c23 = cosf(q23), s23 = sinf(q23);
  const float u = -l2 * s2 - l3 * s23;
  const float w = -l2 * c2 - l3 * c23;
  p[0] = hip[0] + u;
  p[1] = hip[1] + (c1 * s - s1 * w);
  p[2] = hip[2] + (s1 * s + c1 * w);
  J[0] = 0.0f;
  J[1] = w;
  J[2] = -l3 * c23;
  J[3] = -s1 * s - c1 * w;
  J[4] = s1 * u;
  J[5] = -s1 * l3 * s23;
  J[6] = c1 * s - s1 * w;
  J[7] = -c1 * u;
  J[8] = c1 * l3 * s23;
}

// kin.leg_inverse_kinematics: the knee-flexed branch, the knee clipped
// short of full extension.
__host__ __device__ inline void leg_ik(const float* p, const float* hip, float s, float l2,
                                       float l3, float cos_knee_max, float* q) {
  const float rx = p[0] - hip[0], ry = p[1] - hip[1], rz = p[2] - hip[2];
  const float yz_sq = ry * ry + rz * rz;
  const float w = -sqrtf(clamp_lo(yz_sq - s * s, 1e-9f));
  const float q1 = atan2f(rz, ry) - atan2f(w, s);
  q[0] = atan2f(sinf(q1), cosf(q1));
  const float u = rx;
  const float d_sq = u * u + w * w;
  const float cos_q3 = clamp((d_sq - l2 * l2 - l3 * l3) / (2.0f * l2 * l3), -1.0f, cos_knee_max);
  const float q3 = -acosf(cos_q3);
  const float s3 = sinf(q3), c3 = cosf(q3);
  const float q2 = atan2f(-u, -w) - atan2f(l3 * s3, l2 + l3 * c3);
  q[1] = atan2f(sinf(q2), cosf(q2));
  q[2] = q3;
}

// ---- the gait (ops/gaitsched.py) ----

// gaitsched._window_state of one leg.
__host__ __device__ inline float window_state(float phase, float off, float dur) {
  float state = phase - off;
  if (state < 0.0f) state = state + 1.0f;
  const bool pos_dur = dur > 0.0f;
  const float out = state / (pos_dur ? dur : 1.0f);
  return (state > dur || !pos_dur) ? 0.0f : out;
}

// ---- the three kernels' per-robot bodies ----

// srb_env.observe: q and qdot (each (4, 3)) of the rigid-body state.
__host__ __device__ inline void srb_observe_one(const float* const* in, float* const* out,
                                                const ObserveArgs& a) {
  using namespace obs;
  float R[9];
  quat_to_rotmat(in[QUAT], R);
  const float *pos = in[POS], *vel = in[VEL], *omega = in[OMEGA];
  for (int l = 0; l < 4; ++l) {
    const float* hip = in[HIP_OFFSET] + 3 * l;
    const float s = in[HIP_LEN][l], l2 = in[L_THIGH][0], l3 = in[L_CALF][0];
    float d[3], p[3], dv[3], v[3], c[3], q[3], fk[3], J[9], v_rel[3];
    for (int i = 0; i < 3; ++i) d[i] = in[FOOT_POS][3 * l + i] - pos[i];
    vec_mat(d, R, p);
    leg_ik(p, hip, s, l2, l3, a.cos_knee_max, q);
    leg_fk(q, hip, s, l2, l3, fk, J);
    for (int i = 0; i < 3; ++i) dv[i] = in[FOOT_VEL][3 * l + i] - vel[i];
    vec_mat(dv, R, v);
    cross(omega, p, c);
    for (int i = 0; i < 3; ++i) v_rel[i] = v[i] - c[i];
    float qd[3];
    solve3(J, v_rel, qd);
    for (int i = 0; i < 3; ++i) {
      out[Q][3 * l + i] = q[i];
      out[QDOT][3 * l + i] = qd[i];
    }
  }
}

// controller._pre_solve of robot b: compute_kin_state (quirk on), the
// swing phases, the stance table, x_t and integrate_desired.
__host__ __device__ inline void ctrl_pre_one(const float* const* in, float* const* out,
                                             const PreArgs& a, long long b) {
  using namespace pre;
  const float *quat = in[QUAT], *pos = in[POS], *vel = in[VEL], *omega = in[OMEGA];
  float Rm[9], rpy[3];
  quat_to_rotmat(quat, Rm);
  quat_to_zyx(quat, rpy);
  for (int k = 0; k < 9; ++k) out[R][k] = Rm[k];
  for (int k = 0; k < 3; ++k) out[RPY][k] = rpy[k];

  // The quirk term v - R^T v, the same for every leg.
  float RTv[3], quirk[3];
  vec_mat(vel, Rm, RTv);
  for (int i = 0; i < 3; ++i) quirk[i] = vel[i] - RTv[i];

  const float l2 = in[L_THIGH][0], l3 = in[L_CALF][0];
  for (int l = 0; l < 4; ++l) {
    const float* hip = in[HIP_OFFSET] + 3 * l;
    const float* q = in[Q] + 3 * l;
    const float* qd = in[QDOT] + 3 * l;
    const float s = in[HIP_LEN][l];
    float p[3], J[9], pw[3], c[3], Jqd[3];
    leg_fk(q, hip, s, l2, l3, p, J);
    mat_vec(Rm, p, pw);
    cross(omega, p, c);
    mat_vec(J, qd, Jqd);
    const float c1 = cosf(q[0]), s1 = sinf(q[0]);
    const float thigh[3] = {0.0f, c1 * s, s1 * s};
    for (int i = 0; i < 3; ++i) {
      out[P_BF][3 * l + i] = p[i];
      out[POS_BASE_FEET][3 * l + i] = pw[i];
      out[POS_FEET][3 * l + i] = pos[i] + pw[i];
      out[VEL_BF][3 * l + i] = (c[i] + Jqd[i]) + quirk[i];
      out[THIGHS][3 * l + i] = hip[i] + thigh[i];
    }
    for (int k = 0; k < 9; ++k) out[JAC][9 * l + k] = J[k];
  }

  // gaitsched: phase_of_tick, swing_state, gait_table.
  const int n = a.num_segments[b];
  const int32_t* off = a.stance_offsets + 4 * b;
  const int32_t* dur = a.stance_durations + 4 * b;
  const int tick = a.tick_dev ? *a.tick_dev : a.tick;
  const int iteration = floor_mod(floor_div(tick, a.iters), n);
  const int period = a.iters * n;
  const float phase = (float)floor_mod(tick, period) / (float)period;
  const float nf = (float)n;
  for (int l = 0; l < 4; ++l) {
    const float off_n = (float)off[l] / nf, dur_n = (float)dur[l] / nf;
    float swing_off = off_n + dur_n;
    if (swing_off > 1.0f) swing_off = swing_off - 1.0f;
    out[SWING_STATES][l] = window_state(phase, swing_off, 1.0f - dur_n);
  }
  for (int i = 0; i < a.h; ++i) {
    const int seg = floor_mod(i + 1 + iteration, n);
    for (int l = 0; l < 4; ++l) {
      int cur = seg - off[l];
      if (cur < 0) cur = cur + n;
      out[TABLE][4 * i + l] = cur < dur[l] ? 1.0f : 0.0f;
    }
  }

  // x_t = [rpy, pos, omega, vel, -g].
  for (int k = 0; k < 3; ++k) {
    out[X_T][k] = rpy[k];
    out[X_T][3 + k] = pos[k];
    out[X_T][6 + k] = omega[k];
    out[X_T][9 + k] = vel[k];
  }
  const float dt = *a.dt;
  out[X_T][12] = -*a.gravity;

  // refmpc.integrate_desired.
  float vdw[3];
  mat_vec(Rm, in[VEL_DES], vdw);
  for (int k = 0; k < 3; ++k) out[VEL_DES_WORLD][k] = vdw[k];
  const bool first = a.first_run[b] != 0;
  const float yaw = rpy[2];
  out[XPOS_OUT][0] = first ? 0.0f : in[XPOS_DES][0] + dt * vdw[0];
  out[YPOS_OUT][0] = first ? 0.0f : in[YPOS_DES][0] + dt * vdw[1];
  out[YAW_OUT][0] = first ? yaw : yaw + dt * in[YAW_RATE][0];
  a.first_run_out[b] = 0;
}

// swing._hermite_eval of one coordinate: position and velocity.
__host__ __device__ inline void hermite(float p0, float p1, float duration, float t, float* p,
                                        float* v) {
  const float u = clamp(t / duration, 0.0f, 1.0f);
  const float blend = u * u * (3.0f - 2.0f * u);
  const float dblend = 6.0f * u * (1.0f - u) / duration;
  const float diff = p1 - p0;
  *p = p0 + blend * diff;
  *v = dblend * diff;
}

// controller._post_solve of robot b: swing.update_swing, then
// legctrl.leg_torques.
__host__ __device__ inline void ctrl_post_one(const float* const* in, float* const* out,
                                              const PostArgs& a, long long b) {
  using namespace post;
  const float *Rm = in[R], *pos = in[POS], *vel = in[VEL];
  const int n = a.num_segments[b];
  const int dur0 = a.stance_durations[4 * b];
  const float dt = *a.dt, g = *a.gravity;
  const float dt_gait = dt * (float)a.iters;
  const float t_stance = dt_gait * (float)dur0;
  const float t_swing = dt_gait * (float)(n - dur0);
  const float yr = in[YAW_RATE][0];
  const float* vdes = in[VEL_DES];

  float vdw[3];
  mat_vec(Rm, vdes, vdw);
  const float theta = yr * 0.5f * t_stance;
  const float cz = cosf(theta), sz = sinf(theta);
  const float rot[9] = {cz, -sz, 0.0f, sz, cz, 0.0f, 0.0f, 0.0f, 1.0f};
  const float half_stance = 0.5f * t_stance;
  const float coef = 0.5f * pos[2] / g;
  const float centripetal[3] = {coef * (vel[1] * yr), coef * (-vel[0] * yr), coef * 0.0f};
  const float cur_half = t_swing * 0.5f;

  for (int l = 0; l < 4; ++l) {
    const float ss = in[SWING_STATES][l];
    const bool active = ss > 0.0f;
    const bool first = a.is_first[4 * b + l] != 0;
    const float rem_prev = in[REMAINING][l];
    float remaining = first ? t_swing : rem_prev - dt;
    remaining = active ? remaining : rem_prev;

    // Placement: thigh_corr = thigh @ rot^T, then (thigh_corr + vdes rem) @ R^T.
    const float* th = in[THIGHS] + 3 * l;
    float tc[3], x[3], xw[3];
    mat_vec(rot, th, tc);
    for (int i = 0; i < 3; ++i) x[i] = tc[i] + vdes[i] * remaining;
    mat_vec(Rm, x, xw);
    float foothold[3], init[3], fin[3];
    for (int i = 0; i < 3; ++i) {
      foothold[i] = pos[i] + xw[i] + half_stance * vel[i] + 0.03f * (vel[i] - vdw[i]);
      foothold[i] = foothold[i] + centripetal[i];
    }
    const bool latch = active && first;
    for (int i = 0; i < 3; ++i)
      init[i] = latch ? in[POS_FEET][3 * l + i] : in[FOOT_INIT][3 * l + i];
    const float tdz = in[TOUCHDOWN_Z][0];
    foothold[2] = a.ground_adaptive ? init[2] + tdz : tdz;
    for (int i = 0; i < 3; ++i) fin[i] = active ? foothold[i] : in[FOOT_FINAL][3 * l + i];
    bool is_first = active ? false : first;
    if (active && ss >= 1.0f) is_first = true;

    // Trajectory: two Hermite halves through the apex.
    const float cur_t = t_swing - remaining;
    float mid[3];
    for (int i = 0; i < 3; ++i) mid[i] = 0.5f * (init[i] + fin[i]);
    const float sh = in[SWING_HEIGHT][0];
    mid[2] = a.ground_adaptive ? maximum(init[2], fin[2]) + sh : sh;
    const bool in_first = cur_t < cur_half;
    float pw[3], vw[3];
    for (int i = 0; i < 3; ++i) {
      float pa, va, pb, vb;
      hermite(init[i], mid[i], cur_half, cur_t, &pa, &va);
      hermite(mid[i], fin[i], cur_half, cur_t - cur_half, &pb, &vb);
      pw[i] = (in_first ? pa : pb) - pos[i];
      vw[i] = (in_first ? va : vb) - vel[i];
    }
    float pt[3], vt[3];
    vec_mat(pw, Rm, pt);
    vec_mat(vw, Rm, vt);
    for (int i = 0; i < 3; ++i) {
      pt[i] = active ? pt[i] : 0.0f;
      vt[i] = active ? vt[i] : 0.0f;
    }

    // legctrl.leg_torques: PD about the swing targets in swing, -f in stance.
    const bool swinging = ss != 0.0f;
    float pe[3], ve[3], pew[3], vew[3], fw[3], fb[3];
    for (int i = 0; i < 3; ++i) {
      pe[i] = pt[i] - in[P_BF][3 * l + i];
      ve[i] = vt[i] - in[VEL_BF][3 * l + i];
    }
    mat_vec(Rm, pe, pew);
    mat_vec(Rm, ve, vew);
    for (int i = 0; i < 3; ++i)
      fw[i] = swinging ? in[KP][i] * pew[i] + in[KD][i] * vew[i] : -in[FORCES][3 * l + i];
    vec_mat(fw, Rm, fb);
    const float* J = in[JAC] + 9 * l;
    for (int j = 0; j < 3; ++j)
      out[TORQUES][3 * l + j] = J[j] * fb[0] + J[3 + j] * fb[1] + J[6 + j] * fb[2];

    out[REMAINING_OUT][l] = remaining;
    for (int i = 0; i < 3; ++i) {
      out[FOOT_INIT_OUT][3 * l + i] = init[i];
      out[FOOT_FINAL_OUT][3 * l + i] = fin[i];
      out[POS_TARGETS][3 * l + i] = pt[i];
      out[VEL_TARGETS][3 * l + i] = vt[i];
    }
    a.is_first_out[4 * b + l] = is_first ? 1 : 0;
  }
}

}  // namespace ctrl_tick
