"""Plain reference of one closed-loop tick: controller and plant.

Written from the reference controller's equations (ref
``yinghansun/pympc-quadruped``: ``linear_mpc/mpc.py``, ``gait.py``,
``swing_foot_trajectory_generator.py``, ``leg_controller.py``) with the
quirks the system keeps: dt_predict = 0.05 against dt_gait = 0.02, the
+-0.1 m clamp on the desired x/y, the Pinocchio velocity-frame quirk in
the relative foot velocities, the body-frame angular velocity in the MPC
state, the -0.0255 m touchdown height and the strict ``>`` at a gait
window's end.  Batched over rows; no kernels, no graphs, no warm starts.

Every input is a dict of tensors (one row per robot) and every number is
computed in ``prec`` (:mod:`.precision`): float64 for the reference,
float32 with TF32 products for the control.  The gait schedule is a
discrete function of the integer tick; its phase is evaluated in float32,
as the configuration defines it, in both.

A plant is ``"srb"`` (the single rigid body forced by the ground-reaction
forces, stance feet pinned, swing feet on their targets) or
``"fullorder"`` (the 18-DoF tree of :mod:`.rbd` driven by the joint
torques, penalty contact at the feet).
"""
from __future__ import annotations

import torch

from benchmark.reference import rbd
from benchmark.reference.precision import Precision

NUM_STATE = 13


# ------------------------------------------------------------------ rotations


def quat_to_rotmat(q):
    w, x, y, z = q.unbind(-1)
    rows = [
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z)],
        [2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_to_rpy(q):
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], -1)


def rot_z(t):
    c, s = torch.cos(t), torch.sin(t)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def quat_integrate(q, omega_body, dt):
    """q * exp(omega dt / 2), renormalised."""
    norm = torch.linalg.vector_norm(omega_body, dim=-1, keepdim=True)
    axis = omega_body / torch.clamp(norm, min=1e-9)
    half = 0.5 * norm * dt
    w2, v2 = torch.cos(half), torch.sin(half) * axis
    w1, v1 = q[..., :1], q[..., 1:]
    out = torch.cat([w1 * w2 - (v1 * v2).sum(-1, keepdim=True),
                     w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)], -1)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


# ---------------------------------------------------------------- kinematics


def leg_fk(robot, q_legs):
    """Base-frame feet (R,4,3) and Jacobians (R,4,3,3) of hip(x)-thigh(y)-
    calf(y) legs with signed abduction length."""
    q1, q2, q3 = q_legs.unbind(-1)
    s_hip = robot["hip_len"]
    l2, l3 = robot["l_thigh"][:, None], robot["l_calf"][:, None]
    c1, s1 = torch.cos(q1), torch.sin(q1)
    c2, s2 = torch.cos(q2), torch.sin(q2)
    c23, s23 = torch.cos(q2 + q3), torch.sin(q2 + q3)
    u = -l2 * s2 - l3 * s23
    w = -l2 * c2 - l3 * c23
    p = robot["hip_offset"] + torch.stack([u, c1 * s_hip - s1 * w, s1 * s_hip + c1 * w], -1)
    zero = torch.zeros_like(q1)
    J = torch.stack([
        torch.stack([zero, -s1 * s_hip - c1 * w, c1 * s_hip - s1 * w], -1),
        torch.stack([w, s1 * u, -c1 * u], -1),
        torch.stack([-l3 * c23, -s1 * l3 * s23, c1 * l3 * s23], -1),
    ], -1)
    return p, J


def thigh_positions(robot, q_legs):
    q1 = q_legs[..., 0]
    s_hip = robot["hip_len"]
    off = torch.stack([torch.zeros_like(q1), torch.cos(q1) * s_hip, torch.sin(q1) * s_hip], -1)
    return robot["hip_offset"] + off


def leg_ik(robot, p_bf, knee_cos_max):
    """Knee-flexed joint angles of base-frame feet (the SRB plant's joint
    readings); the knee stops ``acos(knee_cos_max)`` short of straight."""
    r = p_bf - robot["hip_offset"]
    s_hip = robot["hip_len"]
    l2, l3 = robot["l_thigh"][:, None], robot["l_calf"][:, None]
    ry, rz = r[..., 1], r[..., 2]
    w = -torch.sqrt(torch.clamp(ry * ry + rz * rz - s_hip * s_hip, min=1e-9))
    q1 = torch.atan2(rz, ry) - torch.atan2(w, s_hip)
    q1 = torch.atan2(torch.sin(q1), torch.cos(q1))
    u = r[..., 0]
    cos_q3 = torch.clamp((u * u + w * w - l2 * l2 - l3 * l3) / (2.0 * l2 * l3), -1.0,
                         knee_cos_max)
    q3 = -torch.acos(cos_q3)
    q2 = torch.atan2(-u, -w) - torch.atan2(l3 * torch.sin(q3), l2 + l3 * torch.cos(q3))
    q2 = torch.atan2(torch.sin(q2), torch.cos(q2))
    return torch.stack([q1, q2, q3], -1)


def kin_state(prec: Precision, robot, obs):
    """What the controller reads from one observation."""
    R = quat_to_rotmat(obs["quat"])
    RT = R.transpose(-1, -2)
    q_legs = obs["q"].reshape(-1, 4, 3)
    qd_legs = obs["qdot"].reshape(-1, 4, 3)
    p_bf, J = leg_fk(robot, q_legs)
    rel = (torch.linalg.cross(obs["omega"][:, None, :].expand_as(p_bf), p_bf, dim=-1)
           + prec.mv(J, qd_legs))
    v = obs["vel"]
    rel = rel + (v - prec.mv(RT, v))[:, None, :]        # the Pinocchio frame quirk
    return dict(R=R, rpy=quat_to_rpy(obs["quat"]), pos=obs["pos"], vel=v,
                omega=obs["omega"], p_bf=p_bf, pos_base_feet=prec.mm(p_bf, RT),
                pos_feet=obs["pos"][:, None, :] + prec.mm(p_bf, RT), v_bf=rel,
                thighs=thigh_positions(robot, q_legs), J=J)


# --------------------------------------------------------------------- gait


def gait_schedule(gait, mpc, tick: int):
    """(swing phase (R,4), stance table (R,4h)) at the integer ``tick``,
    as the configuration defines them (phase in float32)."""
    iters, h = mpc["iterations_between_mpc"], mpc["horizon"]
    n = gait["num_segments"]                                   # (R,) int64
    iteration = (tick // iters) % n
    steps = torch.arange(h, device=n.device)
    seg = (steps[None, :] + 1 + iteration[:, None]) % n[:, None]
    cur = seg[:, :, None] - gait["stance_offsets"][:, None, :]
    cur = torch.where(cur < 0, cur + n[:, None, None], cur)
    table = (cur < gait["stance_durations"][:, None, :]).reshape(-1, 4 * h)
    period = iters * n
    phase = ((tick % period).to(torch.float32) / period.to(torch.float32))[:, None]
    off = gait["stance_offsets"].to(torch.float32) / n.to(torch.float32)[:, None]
    dur = gait["stance_durations"].to(torch.float32) / n.to(torch.float32)[:, None]
    sw_off = off + dur
    sw_off = torch.where(sw_off > 1.0, sw_off - 1.0, sw_off)
    sw_dur = 1.0 - dur
    state = phase - sw_off
    state = torch.where(state < 0.0, state + 1.0, state)
    pos = sw_dur > 0.0
    out = state / torch.where(pos, sw_dur, torch.ones_like(sw_dur))
    swing = torch.where((state > sw_dur) | ~pos, torch.zeros_like(out), out)
    return swing, table


# --------------------------------------------------------------- controller


def _c(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def integrate_desired(prec, mpc, carry, ks, cmd):
    """The every-tick desired-state update of the MPC carry."""
    vel_des_world = prec.mv(ks["R"], cmd["vel"])
    first = carry["mpc.first_run"]
    zero = torch.zeros_like(vel_des_world[:, 0])
    dt = _c(mpc["dt_control"], zero)
    out = dict(carry)
    out["mpc.xpos_des"] = torch.where(first, zero, carry["mpc.xpos_des"] + dt * vel_des_world[:, 0])
    out["mpc.ypos_des"] = torch.where(first, zero, carry["mpc.ypos_des"] + dt * vel_des_world[:, 1])
    yaw = ks["rpy"][:, 2]
    out["mpc.yaw_des"] = torch.where(first, yaw, yaw + dt * cmd["yaw_rate"])
    out["mpc.first_run"] = torch.zeros_like(first)
    return out, vel_des_world


def reference_trajectory(mpc, robot, carry, x_t, vel_des_world, cmd, table):
    """X_ref (R,h,13) of a solve tick and the carry's clamped targets and
    compensation integrators."""
    h, dt = mpc["horizon"], mpc["dt_predict"]
    if not bool(table.reshape(-1, h, 4).any(-1).all()):
        raise ValueError("a gait with a full-flight step needs the flight-aware rows")
    e = mpc["max_pos_error"]
    xpos = torch.minimum(torch.maximum(carry["mpc.xpos_des"], x_t[:, 3] - e), x_t[:, 3] + e)
    ypos = torch.minimum(torch.maximum(carry["mpc.ypos_des"], x_t[:, 4] - e), x_t[:, 4] + e)
    vx, vy = x_t[:, 9], x_t[:, 10]
    pitch_int = torch.where(vx.abs() > 0.2, carry["mpc.pitch_comp_int"] + dt * (0.0 - x_t[:, 1]) / vx,
                            carry["mpc.pitch_comp_int"])
    roll_int = torch.where(vy.abs() > 0.1, carry["mpc.roll_comp_int"] + dt * (0.0 - x_t[:, 0]) / vy,
                           carry["mpc.roll_comp_int"])
    sat = mpc["comp_saturation"]
    pitch_int = torch.clamp(pitch_int, -sat, sat)
    roll_int = torch.clamp(roll_int, -sat, sat)
    steps = torch.arange(h, dtype=x_t.dtype, device=x_t.device)[None, :]
    X = torch.zeros(x_t.shape[0], h, NUM_STATE, dtype=x_t.dtype, device=x_t.device)
    X[:, :, 0] = (vy * roll_int)[:, None]
    X[:, :, 1] = (vx * pitch_int)[:, None]
    X[:, :, 2] = carry["mpc.yaw_des"][:, None] + dt * cmd["yaw_rate"][:, None] * steps
    X[:, :, 3] = xpos[:, None] + dt * vel_des_world[:, 0:1] * steps
    X[:, :, 4] = ypos[:, None] + dt * vel_des_world[:, 1:2] * steps
    X[:, :, 5] = robot["base_height_des"][:, None]
    X[:, :, 8] = cmd["yaw_rate"][:, None]
    X[:, :, 9] = vel_des_world[:, 0:1]
    X[:, :, 10] = vel_des_world[:, 1:2]
    X[:, :, 12] = -mpc["gravity"]
    out = dict(carry)
    out.update({"mpc.xpos_des": xpos, "mpc.ypos_des": ypos, "mpc.roll_comp_int": roll_int,
                "mpc.pitch_comp_int": pitch_int})
    return out, X


def discrete_model(prec, mpc, robot, yaw, feet_world):
    """The single-rigid-body prediction model at dt_predict: (Ad, Bd)."""
    Rz = rot_z(yaw)
    I_w = prec.mm(prec.mm(Rz, robot["inertia"]), Rz.transpose(-1, -2))
    inv_I = torch.linalg.inv(I_w)
    R_ = yaw.shape[0]
    Ac = yaw.new_zeros(R_, NUM_STATE, NUM_STATE)
    Ac[:, 0:3, 6:9] = Rz.transpose(-1, -2)
    Ac[:, 3:6, 9:12] = torch.eye(3, dtype=yaw.dtype, device=yaw.device)
    Ac[:, 11, 12] = 1.0
    Bc = yaw.new_zeros(R_, NUM_STATE, 12)
    for leg in range(4):
        Bc[:, 6:9, 3 * leg:3 * leg + 3] = prec.mm(inv_I, skew(feet_world[:, leg]))
        for i in range(3):
            Bc[:, 9 + i, 3 * leg + i] = 1.0 / robot["mass"]
    dt = mpc["dt_predict"]
    eye = torch.eye(NUM_STATE, dtype=yaw.dtype, device=yaw.device)
    A2 = prec.mm(Ac, Ac)
    Ad = eye + Ac * dt + A2 * (0.5 * dt * dt)
    Bd = prec.mm(eye * dt + Ac * (0.5 * dt * dt) + A2 * (dt ** 3 / 6.0), Bc)
    return Ad, Bd


def condensed_qp(prec, mpc, Ad, Bd, x_t, X_ref, table):
    """Masked condensed QP (H, g) over U (12h) and the stance mask:
    X = Sx x_t + Su U, cost sum (X - X_ref)^T Q (X - X_ref) + U^T R U,
    swing-leg forces pinned to 0 by an identity row with zero gradient."""
    h = mpc["horizon"]
    R_ = Ad.shape[0]
    pows = [torch.eye(NUM_STATE, dtype=Ad.dtype, device=Ad.device).expand(R_, -1, -1)]
    for _ in range(h):
        pows.append(prec.mm(pows[-1], Ad))
    Sx = torch.cat(pows[1:], dim=1)
    M = [prec.mm(pows[k], Bd) for k in range(h)]
    Su = Ad.new_zeros(R_, NUM_STATE * h, 12 * h)
    for i in range(h):
        for j in range(i + 1):
            Su[:, 13 * i:13 * i + 13, 12 * j:12 * j + 12] = M[i - j]
    q_bar = _c(mpc["q_diag"], Ad).repeat(h)
    r_bar = _c(mpc["r_diag"], Ad).repeat(h)
    SuT = Su.transpose(-1, -2)
    QSu = q_bar[:, None] * Su
    H = prec.mm(SuT, QSu)
    H = H + H.transpose(-1, -2) + 2.0 * torch.diag(r_bar)
    resid = prec.mv(Sx, x_t) - X_ref.reshape(R_, -1)
    g = 2.0 * prec.mv(SuT, q_bar * resid)
    mv = torch.repeat_interleave(table.to(Ad.dtype), 3, dim=-1)
    H = H * mv[:, :, None] * mv[:, None, :] + torch.diag_embed(1.0 - mv)
    return H, g * mv, mv


def update_swing(prec, mpc, robot, gait, cmd, ks, carry, swing):
    """Swing-foot latches, footholds and the two-segment Hermite targets
    (base frame, relative to the base; zero on stance legs)."""
    active = swing > 0.0
    dtg = mpc["dt_control"] * mpc["iterations_between_mpc"]
    n = gait["num_segments"].to(ks["pos"].dtype)
    st_seg = gait["stance_durations"][:, 0].to(ks["pos"].dtype)
    t_stance = (dtg * st_seg)[:, None]
    t_swing = (dtg * (n - st_seg))[:, None]
    R, RT = ks["R"], ks["R"].transpose(-1, -2)
    vel_des_world = prec.mv(R, cmd["vel"])
    first_sw = carry["swing.is_first_swing"]
    remaining = torch.where(first_sw, t_swing.expand_as(carry["swing.remaining_swing_time"]),
                            carry["swing.remaining_swing_time"] - mpc["dt_control"])
    remaining = torch.where(active, remaining, carry["swing.remaining_swing_time"])
    rot_yaw = rot_z(cmd["yaw_rate"] * 0.5 * t_stance[:, 0])
    thigh = prec.mm(ks["thighs"], rot_yaw.transpose(-1, -2))
    foothold = (ks["pos"][:, None, :]
                + prec.mm(thigh + cmd["vel"][:, None, :] * remaining[..., None], RT)
                + 0.5 * t_stance[..., None] * ks["vel"][:, None, :]
                + 0.03 * (ks["vel"] - vel_des_world)[:, None, :])
    yr = cmd["yaw_rate"]
    coef = (0.5 * ks["pos"][:, 2] / mpc["gravity"])[:, None]
    foothold = foothold + (coef * torch.stack([ks["vel"][:, 1] * yr, -ks["vel"][:, 0] * yr,
                                               torch.zeros_like(yr)], -1))[:, None, :]
    init = torch.where((active & first_sw)[..., None], ks["pos_feet"], carry["swing.footpos_init"])
    foothold = torch.cat([foothold[..., :2],
                          robot["touchdown_z"][:, None, None].expand(-1, 4, 1)], -1)
    final = torch.where(active[..., None], foothold, carry["swing.footpos_final"])
    is_first = torch.where(active, torch.zeros_like(active), first_sw)
    is_first = torch.where(active & (swing >= 1.0), torch.ones_like(active), is_first)
    t = t_swing - remaining
    half = t_swing * 0.5
    mid = 0.5 * (init + final)
    mid = torch.cat([mid[..., :2], robot["swing_height"][:, None, None].expand(-1, 4, 1)], -1)

    def hermite(p0, p1, s):
        u = torch.clamp(s / half, 0.0, 1.0)
        return (p0 + (u * u * (3.0 - 2.0 * u))[..., None] * (p1 - p0),
                (6.0 * u * (1.0 - u) / half)[..., None] * (p1 - p0))

    p_a, v_a = hermite(init, mid, t)
    p_b, v_b = hermite(mid, final, t - half)
    first_half = (t < half)[..., None]
    pos_w = torch.where(first_half, p_a, p_b)
    vel_w = torch.where(first_half, v_a, v_b)
    pos_t = prec.mm(pos_w - ks["pos"][:, None, :], R)
    vel_t = prec.mm(vel_w - ks["vel"][:, None, :], R)
    zero = torch.zeros_like(pos_t)
    out = dict(carry)
    out.update({"swing.is_first_swing": is_first, "swing.remaining_swing_time": remaining,
                "swing.footpos_init": init, "swing.footpos_final": final})
    return (out, torch.where(active[..., None], pos_t, zero),
            torch.where(active[..., None], vel_t, zero))


def leg_torques(prec, robot, ks, forces, swing, pos_t, vel_t):
    """tau = J^T R^T F per leg: F = -GRF on stance legs, the swing PD on
    swing legs."""
    R, RT = ks["R"], ks["R"].transpose(-1, -2)
    f_swing = (robot["kp_swing"][:, None, :] * prec.mm(pos_t - ks["p_bf"], RT)
               + robot["kd_swing"][:, None, :] * prec.mm(vel_t - ks["v_bf"], RT))
    f_world = torch.where((swing != 0.0)[..., None], f_swing, -forces.reshape(-1, 4, 3))
    f_base = prec.mm(f_world, R)
    return (ks["J"] * f_base[..., :, None]).sum(-2).reshape(-1, 12)


# -------------------------------------------------------------------- plants


def srb_observe(prec, robot, state, knee_cos_max):
    """Joint readings of the SRB plant by inverse kinematics."""
    R = quat_to_rotmat(state["quat"])
    p_bf = prec.mm(state["foot_pos"] - state["pos"][:, None, :], R)
    q = leg_ik(robot, p_bf, knee_cos_max)
    _, J = leg_fk(robot, q)
    v_rel = (prec.mm(state["foot_vel"] - state["vel"][:, None, :], R)
             - torch.linalg.cross(state["omega_body"][:, None, :].expand_as(p_bf), p_bf, dim=-1))
    qd = torch.linalg.solve(J, v_rel[..., None])[..., 0]
    return dict(pos=state["pos"], vel=state["vel"], quat=state["quat"],
                omega=state["omega_body"], q=q.reshape(-1, 12), qdot=qd.reshape(-1, 12))


def srb_step(prec, mpc, robot, state, forces, swing, swing_world):
    """Semi-implicit Euler of the trunk under the stance forces; stance
    feet stay, swing feet go to their targets, never below z = 0."""
    dt = mpc["dt_control"]
    f = forces.reshape(-1, 4, 3)
    stance = (swing == 0.0)[..., None]
    f = torch.where(stance, f, torch.zeros_like(f))
    acc = f.sum(-2) / robot["mass"][:, None]
    acc = torch.cat([acc[:, :2], acc[:, 2:] - mpc["gravity"]], -1)
    R = quat_to_rotmat(state["quat"])
    RT = R.transpose(-1, -2)
    torque = torch.linalg.cross(state["foot_pos"] - state["pos"][:, None, :], f, dim=-1).sum(-2)
    I_w = prec.mm(prec.mm(R, robot["inertia"]), RT)
    w_world = prec.mv(R, state["omega_body"])
    dw = torch.linalg.solve(I_w, (torque - torch.linalg.cross(w_world, prec.mv(I_w, w_world),
                                                              dim=-1))[..., None])[..., 0]
    w_world = w_world + dt * dw
    vel = state["vel"] + dt * acc
    sw = torch.cat([swing_world[..., :2], torch.clamp(swing_world[..., 2:], min=0.0)], -1)
    feet = torch.where(stance, state["foot_pos"], sw)
    return dict(pos=state["pos"] + dt * vel, quat=quat_integrate(state["quat"], prec.mv(RT, w_world), dt),
                vel=vel, omega_body=prec.mv(RT, w_world), foot_pos=feet,
                foot_vel=torch.where(stance, torch.zeros_like(feet), (feet - state["foot_pos"]) / dt))


def srb_diverged(state):
    finite = torch.stack([torch.isfinite(v).flatten(1).all(-1) for v in state.values()]).all(0)
    rel_h = state["pos"][:, 2] - state["foot_pos"][:, :, 2].mean(-1)
    ok = (rel_h > 0.05) & (rel_h < 1.0) & (torch.linalg.vector_norm(state["vel"], dim=-1) < 10.0)
    return ~(finite & ok)


def fullorder_observe(prec, state):
    R = quat_to_rotmat(state["quat"])
    return dict(pos=state["pos"], vel=prec.mv(R, state["u"][:, 3:6]), quat=state["quat"],
                omega=state["u"][:, :3], q=state["q"], qdot=state["u"][:, 6:])


#: A foot sphere within this distance of the ground [m] is at the contact
#: switch to rounding: float32 and float64 positions may put it on either
#: side, and the damper's force jumps there.
CONTACT_EDGE = 1e-6


def fullorder_step(prec, robot, model, contact, state, tau, dt, other_side=False):
    """One semi-implicit Euler step of the torque-driven tree with penalty
    contact: spring-damper normal force on the foot sphere's penetration,
    viscous tangential force clamped to the friction disc.  With
    ``other_side`` each foot within :data:`CONTACT_EDGE` of the ground
    takes the other side of the contact switch."""
    R = quat_to_rotmat(state["quat"])
    RT = R.transpose(-1, -2)
    p_bf, J = leg_fk(robot, state["q"].reshape(-1, 4, 3))
    u = state["u"]
    v_rel = (u[:, None, 3:6] + torch.linalg.cross(u[:, None, :3].expand_as(p_bf), p_bf, dim=-1)
             + prec.mv(J, u[:, 6:].reshape(-1, 4, 3)))
    p_feet = state["pos"][:, None, :] + prec.mm(p_bf, RT)
    v_feet = prec.mm(v_rel, RT)
    phi = p_feet[..., 2] - contact["foot_radius"]
    pen = torch.clamp(-phi, min=0.0)
    touch = pen > 0.0
    if other_side:
        touch = touch ^ (phi.abs() < CONTACT_EDGE)
    touch = touch.to(pen.dtype)
    fn = torch.clamp(contact["kn"] * pen - contact["cn"] * v_feet[..., 2] * touch, min=0.0)
    fn = torch.clamp(fn * touch, max=contact["fn_max"])
    ft = -contact["kt"] * v_feet[..., :2] * touch[..., None]
    cap = contact["mu"] * fn[..., None]
    ft = ft * torch.clamp(cap / torch.clamp(torch.linalg.vector_norm(ft, dim=-1, keepdim=True),
                                            min=1e-9), max=1.0)
    f_feet = torch.cat([ft, fn[..., None]], -1)
    tau = torch.clamp(tau, -contact["tau_max"], contact["tau_max"])
    du = rbd.forward_dynamics(prec, model, state["q"], u, R, tau, f_feet)
    u_new = u + dt * du
    return dict(pos=state["pos"] + dt * prec.mv(R, u_new[:, 3:6]),
                quat=quat_integrate(state["quat"], u_new[:, :3], dt), u=u_new,
                q=state["q"] + dt * u_new[:, 6:])


def fullorder_diverged(state):
    finite = torch.stack([torch.isfinite(v).flatten(1).all(-1) for v in state.values()]).all(0)
    h = state["pos"][:, 2]
    ok = (h > 0.08) & (h < 1.0) & (torch.linalg.vector_norm(state["u"][:, 3:6], dim=-1) < 10.0)
    return ~(finite & ok)


# ---------------------------------------------------------------------- tick


def tick(prec: Precision, plant: str, mpc, robot, gait, cmd, state, carry, t: int,
         forces=None, model=None, contact=None, knee_cos_max=None, other_side=False):
    """One closed-loop tick at the integer tick ``t`` from (state, carry).

    On a solve tick (``t`` a multiple of ``iterations_between_mpc``) the
    returned ``qp`` holds the prediction model, the condensed QP and the
    stance mask that the solve is posed on; the tick then steps the plant
    with ``forces`` (R,12), the ground-reaction forces of that solve's
    first step, which the caller supplies.  On any other tick the
    carry's held forces act.  Returns dict(qp, state, carry, torques,
    diverged): the plant's and the carry's values after the tick, before
    any reset of a diverged row.  ``other_side``: the articulated plant's
    feet at the contact switch take its other side (:func:`fullorder_step`)."""
    solve = t % mpc["iterations_between_mpc"] == 0
    if plant == "srb":
        obs = srb_observe(prec, robot, state, knee_cos_max)
    else:
        obs = fullorder_observe(prec, state)
    ks = kin_state(prec, robot, obs)
    swing, table = gait_schedule(gait, mpc, t)
    swing = swing.to(prec.dtype)
    x_t = torch.cat([ks["rpy"], ks["pos"], ks["omega"], ks["vel"],
                     torch.full_like(ks["pos"][:, :1], -mpc["gravity"])], -1)
    carry, vel_des_world = integrate_desired(prec, mpc, carry, ks, cmd)
    qp = None
    if solve:
        carry, X = reference_trajectory(mpc, robot, carry, x_t, vel_des_world, cmd, table)
        Ad, Bd = discrete_model(prec, mpc, robot, x_t[:, 2], ks["pos_base_feet"])
        H, g, mv = condensed_qp(prec, mpc, Ad, Bd, x_t, X, table)
        qp = dict(Ad=Ad, Bd=Bd, H=H, g=g, mv=mv, table=table, x_t=x_t, X_ref=X)
        if forces is None:
            raise ValueError("a solve tick needs the solve's forces")
        held = forces
        carry["mpc.contact_forces"] = forces
    else:
        held = carry["mpc.contact_forces"]
    carry, pos_t, vel_t = update_swing(prec, mpc, robot, gait, cmd, ks, carry, swing)
    tau = leg_torques(prec, robot, ks, held, swing, pos_t, vel_t)
    if plant == "srb":
        swing_world = ks["pos"][:, None, :] + prec.mm(pos_t, ks["R"].transpose(-1, -2))
        nxt = srb_step(prec, mpc, robot, state, held, swing, swing_world)
        bad = srb_diverged(nxt)
    else:
        nxt = fullorder_step(prec, robot, model, contact, state, tau, mpc["dt_control"],
                             other_side)
        bad = fullorder_diverged(nxt)
    return dict(qp=qp, state=nxt, carry=carry, torques=tau, diverged=bad)
