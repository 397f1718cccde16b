"""Batched full-order articulated environment (port of ``env/fullorder.py``).

The 18-DoF articulated tree of :mod:`..ops.rbd` (CRBA + RNEA), a penalty
contact model at the feet, and the controller driving the 12 joint motors
with **torques**, where :mod:`.srb_env` applies the MPC's ground-reaction
forces to the trunk.  It is the JAX package's on-device counterpart of the
reference's IsaacGym loop: leg inertia back-reaction, swing dynamics and
torque-level errors are all real.

Contact: per-foot sphere-on-plane spring-damper normal force with a viscous
tangential force clamped to the friction cone; on terrain the support
height under each foot comes from ``terrain.height_at`` and the normal stays
vertical.  Every function takes a leading scenario axis.

:func:`rollout` is the closed loop.  On a CUDA device the non-solve tick
(sensors and filter in estimator mode, controller, every physics substep,
divergence, auto-reset and metrics) is captured once per call as a
``torch.cuda.CUDAGraph`` (:class:`RolloutLoop`, a :class:`..graph_loop.GraphLoop`)
and replayed on every tick where ``tick % iterations_between_mpc != 0``;
the solve tick runs eagerly behind the host gate, so the solver kernels
launch, and count, outside the graph.  On CPU inputs the same tick runs
eagerly on every tick.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.env import mjcf, srb_env
from pympc_quadruped_tpu_torch.env import terrain as terrain_lib
from pympc_quadruped_tpu_torch.env.graph_loop import GraphLoop
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.models.command import Command
from pympc_quadruped_tpu_torch.models.gaits import GaitParams
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams, a1
from pympc_quadruped_tpu_torch.ops import kin, lie, rbd
from pympc_quadruped_tpu_torch.tree import tile, tree_map
from pympc_quadruped_tpu_torch.utils import profiling


def rbd_model(robot: RobotParams, spec: mjcf.MjcfSpec) -> rbd.RbdModel:
    """The :class:`..ops.rbd.RbdModel` of ``robot`` (any leading scenario
    axes) and its inertial ``spec``, the pair the JAX package's MJCF
    generator reads, so the dynamics and the generated MuJoCo model are one
    model.  Link COMs are mirrored in y for the right legs."""
    lead = robot.mass.shape
    f32 = dict(dtype=torch.float32, device=robot.mass.device)
    mirror = torch.sign(robot.hip_len)                         # (...,4) +1 left, -1 right
    legs = lead + (4,)

    def link_arrays(link):
        com = torch.tensor(link.com, **f32)
        com = torch.stack([com[0].expand(legs), mirror * com[1], com[2].expand(legs)], dim=-1)
        mass = torch.full(legs, link.mass, **f32)
        inertia = torch.diag(torch.tensor(link.diag, **f32)).expand(legs + (3, 3))
        return mass, com, inertia

    hm, hc, hi = link_arrays(spec.hip)
    tm, tc, ti = link_arrays(spec.thigh)
    cm, cc, ci = link_arrays(spec.calf)

    zeros = torch.zeros(legs, **f32)
    l_thigh = robot.l_thigh[..., None].expand(legs)
    l_calf = robot.l_calf[..., None].expand(legs)
    joint_origin = torch.stack([
        robot.hip_offset,                                          # hip
        torch.stack([zeros, robot.hip_len, zeros], dim=-1),        # thigh
        torch.stack([zeros, zeros, -l_thigh], dim=-1),             # calf
    ], dim=-2)                                                     # (...,4,3,3)
    eye = torch.eye(3, **f32)
    joint_axis = torch.stack([eye[0], eye[1], eye[1]]).expand(legs + (3, 3))
    foot_offset = torch.stack([zeros, zeros, -l_calf], dim=-1)

    trunk = spec.trunk_inertial
    return rbd.RbdModel(
        trunk_mass=torch.full(lead, trunk.mass, **f32),
        trunk_com=torch.tensor(trunk.com, **f32).expand(lead + (3,)),
        trunk_inertia=torch.diag(torch.tensor(trunk.diag, **f32)).expand(lead + (3, 3)),
        link_mass=torch.stack([hm, tm, cm], dim=-1),
        link_com=torch.stack([hc, tc, cc], dim=-2),
        link_inertia=torch.stack([hi, ti, ci], dim=-3),
        joint_origin=joint_origin,
        joint_axis=joint_axis,
        foot_offset=foot_offset,
        armature=torch.full(legs + (3,), spec.joint_armature, **f32),
        damping=torch.full(legs + (3,), spec.joint_damping, **f32),
        gravity=torch.full(lead, 9.81, **f32),
    )


@dataclass
class ContactParams:
    """Penalty-contact gains and the actuation and contact saturations
    (0-d tensors), which keep the explicit 1 ms integrator stable through
    falls and near-singular legs.  ``fn_max`` mirrors the MPC's per-foot
    bound; ``tau_max`` defaults to 1 kN*m, effectively unclamped, as the
    reference applies its torques.  :meth:`default` gives the JAX package's
    defaults (kn = 1e4 N/m: static penetration ~9 mm under Aliengo)."""

    kn: torch.Tensor
    cn: torch.Tensor
    kt: torch.Tensor
    mu: torch.Tensor
    foot_radius: torch.Tensor
    tau_max: torch.Tensor
    fn_max: torch.Tensor

    @staticmethod
    def default(device="cuda", **overrides) -> "ContactParams":
        """The defaults on ``device``; keyword arguments replace fields."""
        values = dict(kn=1.0e4, cn=150.0, kt=300.0, mu=0.7, foot_radius=0.0255,
                      tau_max=1000.0, fn_max=500.0)
        values.update(overrides)
        return ContactParams(**{k: torch.tensor(v, dtype=torch.float32, device=device)
                                for k, v in values.items()})


def _a1_tuned(kp_swing: float, device) -> RobotParams:
    """A1 with the true trunk inertia, a reachable 0.32 m standing height and
    swing PD gain ``kp_swing``."""
    base = a1(device)
    return dataclasses.replace(
        base, inertia=base.inertia / 10.0,
        base_height_des=torch.tensor(0.32, dtype=torch.float32, device=device),
        kp_swing=torch.full((3,), kp_swing, dtype=torch.float32, device=device))


def a1_env_config(device="cuda"):
    """``(RobotParams, ContactParams)`` under which A1 trots stably at
    <= 0.8 m/s: the true URDF trunk inertia (not the reference's x10), a
    reachable standing height of 0.32 m (the reference's 0.42 m is full
    extension), swing PD 300 (700 saturates the limit), and the 33.5 N*m
    hardware torque limit."""
    return _a1_tuned(300.0, device), ContactParams.default(device, tau_max=33.5)


def a1_isaacgym_parity_config(device="cuda"):
    """A1 under the reference's actuation: swing PD 700 and no torque clamp,
    on the tuned model of :func:`a1_env_config`.  Run it with
    ``rollout(..., substeps=4)``: the unclamped 700-gain PD exceeds the
    explicit 1 ms integrator's stability margin near leg singularities."""
    return _a1_tuned(700.0, device), ContactParams.default(device)


@dataclass
class FullOrderState:
    """Generalized state per scenario."""

    pos: torch.Tensor    # (...,3) world trunk origin
    quat: torch.Tensor   # (...,4) wxyz
    u: torch.Tensor      # (...,18) [omega_body, v_body, qd]
    q: torch.Tensor      # (...,12) joints, FL FR RL RR x (hip, thigh, calf)


def default_init_state(robot: RobotParams, foot_radius=None) -> FullOrderState:
    """Nominal stance (q = (0, 0.8, -1.6) x 4, ref mujoco_aliengo.py:32-39)
    with the foot spheres resting on the ground; the base height comes from
    the stance FK.  ``foot_radius`` defaults to ``-robot.touchdown_z``, the
    ``ContactParams`` default; :func:`rollout` passes its contact radius."""
    if foot_radius is None:
        foot_radius = -robot.touchdown_z
    lead = robot.mass.shape
    f32 = dict(dtype=torch.float32, device=robot.mass.device)
    q0 = torch.tensor([0.0, 0.8, -1.6], **f32).repeat(4).expand(lead + (12,)).contiguous()
    p_bf, _ = kin.leg_forward_kinematics(robot, q0.reshape(lead + (4, 3)))
    z0 = -p_bf[..., 2].amin(dim=-1) + foot_radius
    e_z = torch.tensor([0.0, 0.0, 1.0], **f32)
    return FullOrderState(
        pos=e_z * z0[..., None],
        quat=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).expand(lead + (4,)).contiguous(),
        u=torch.zeros(lead + (18,), **f32),
        q=q0,
    )


def init_state_on_terrain(robot: RobotParams, terrain: terrain_lib.Terrain,
                          foot_radius=None) -> FullOrderState:
    """Nominal stance raised by the mean ground height under the feet (the
    contact springs absorb the per-foot mismatch in the first few ms)."""
    s = default_init_state(robot, foot_radius)
    R = lie.quat_to_rotmat(s.quat)
    lead = s.q.shape[:-1]
    p_bf, _ = kin.leg_forward_kinematics(robot, s.q.reshape(lead + (4, 3)))
    feet_xy = (s.pos[..., None, :] + p_bf @ R.transpose(-1, -2))[..., :2]
    gz = terrain_lib.height_at(terrain, feet_xy)
    pos = torch.cat([s.pos[..., :2], s.pos[..., 2:] + gz.mean(dim=-1, keepdim=True)], dim=-1)
    return dataclasses.replace(s, pos=pos)


def foot_kinematics(robot: RobotParams, state: FullOrderState):
    """World positions and velocities (...,4,3) of the foot points and the
    base rotation: v_foot = R (v_b + omega x p_bf + J qd)."""
    R = lie.quat_to_rotmat(state.quat)
    lead = state.q.shape[:-1]
    q_legs = state.q.reshape(lead + (4, 3))
    qd_legs = state.u[..., 6:].reshape(lead + (4, 3))
    p_bf, J = kin.leg_forward_kinematics(robot, q_legs)
    v_bf = (J @ qd_legs[..., None])[..., 0]
    w, v_b = state.u[..., :3], state.u[..., 3:6]
    v_rel = v_b[..., None, :] + torch.linalg.cross(w[..., None, :].expand_as(p_bf), p_bf,
                                                   dim=-1) + v_bf
    RT = R.transpose(-1, -2)
    return state.pos[..., None, :] + p_bf @ RT, v_rel @ RT, R


def contact_forces(cp: ContactParams, p_feet: torch.Tensor, v_feet: torch.Tensor,
                   ground_z=0.0) -> torch.Tensor:
    """(...,4,3) world-frame penalty contact forces at the foot points.

    Normal: spring-damper on the sphere's penetration of the support
    height ``ground_z`` (...,4), clamped to [0, fn_max].  Tangential:
    viscous, clamped to the mu * fn Coulomb disc."""
    phi = p_feet[..., 2] - ground_z - cp.foot_radius           # penetration < 0
    pen = torch.clamp(-phi, min=0.0)
    in_contact = (pen > 0.0).to(p_feet.dtype)
    fn = torch.clamp(cp.kn * pen - cp.cn * v_feet[..., 2] * in_contact, min=0.0)
    fn = torch.minimum(fn * in_contact, cp.fn_max)
    ft = -cp.kt * v_feet[..., :2] * in_contact[..., None]
    ft_norm = torch.linalg.vector_norm(ft, dim=-1, keepdim=True)
    cap = cp.mu * fn[..., None]
    ft = ft * torch.clamp(cap / torch.clamp(ft_norm, min=1e-9), max=1.0)
    return torch.cat([ft, fn[..., None]], dim=-1)


def physics_step(
    model: rbd.RbdModel,
    robot: RobotParams,
    cp: ContactParams,
    state: FullOrderState,
    tau: torch.Tensor,
    dt,
    terrain: terrain_lib.Terrain | None = None,
):
    """One semi-implicit Euler step of the torque-driven tree.

    Returns ``(new_state, f_feet)``, the (...,4,3) world contact forces of
    the step, which the estimator's measured-contact gate reads."""
    p_feet, v_feet, R = foot_kinematics(robot, state)
    f_feet = contact_forces(cp, p_feet, v_feet, _ground(terrain, p_feet))
    tau = torch.minimum(torch.maximum(tau, -cp.tau_max), cp.tau_max)
    du = rbd.forward_dynamics(model, state.q, state.u, R, tau, f_feet)
    u_new = state.u + dt * du
    q_new = state.q + dt * u_new[..., 6:]
    quat_new = lie.quat_integrate(state.quat, u_new[..., :3], dt)
    pos_new = state.pos + dt * (R @ u_new[..., 3:6, None])[..., 0]
    return FullOrderState(pos=pos_new, quat=quat_new, u=u_new, q=q_new), f_feet


def observe(robot: RobotParams, state: FullOrderState) -> kin.RobotObs:
    """Ground-truth observation in the controller's interface."""
    R = lie.quat_to_rotmat(state.quat)
    return kin.RobotObs(
        pos_base=state.pos,
        lin_vel_base=(R @ state.u[..., 3:6, None])[..., 0],
        quat_base=state.quat,
        ang_vel_base=state.u[..., :3],
        q=state.q,
        qdot=state.u[..., 6:],
    )


def _diverged(state: FullOrderState, ground_z: torch.Tensor) -> torch.Tensor:
    """(B,) divergence flags: a non-finite state, or a trunk height above
    the local ground ``ground_z`` (B,) outside (0.08, 1.0) m, or a body
    speed of 10 m/s or more."""
    finite = (
        torch.isfinite(state.pos).all(dim=-1)
        & torch.isfinite(state.quat).all(dim=-1)
        & torch.isfinite(state.u).all(dim=-1)
        & torch.isfinite(state.q).all(dim=-1)
    )
    rel_h = state.pos[:, 2] - ground_z
    plausible = (rel_h > 0.08) & (rel_h < 1.0) & (
        torch.linalg.vector_norm(state.u[:, 3:6], dim=-1) < 10.0)
    return ~(finite & plausible)


def _ground(terrain, p: torch.Tensor) -> torch.Tensor:
    """Support height under the points ``p`` (...,3): the terrain's, or 0."""
    if terrain is None:
        return torch.zeros_like(p[..., 2])
    return terrain_lib.height_at(terrain, p[..., :2])


def init_full_carry(robot: RobotParams, mpc: MpcParams, state0: FullOrderState,
                    cp: ContactParams, carry0=None, estimator: kf.KfParams | None = None,
                    terrain: terrain_lib.Terrain | None = None):
    """The rollout's full loop carry at ``state0``.

    Truth mode: the controller carry ``carry0`` (a fresh one by default).
    Estimator mode: ``(controller_carry, kf_state, vworld, f_feet)``: the
    filter started at the base and feet of ``state0``, the world velocity
    the accelerometer differences against, and the contact forces of the
    initial state, which gate the first tick's measured contact."""
    B = robot.mass.shape[0]
    if carry0 is None:
        carry0 = tile(ctrl.init_carry(mpc.horizon, device=robot.mass.device), B)
    if estimator is None:
        return carry0
    feet0, vfeet0, R0 = foot_kinematics(robot, state0)
    kf0 = kf.KfState.init(state0.pos, feet0)
    vworld0 = (R0 @ state0.u[:, 3:6, None])[..., 0]
    f0 = contact_forces(cp, feet0, vfeet0, _ground(terrain, feet0))
    return (carry0, kf0, vworld0, f0)


class RolloutLoop(GraphLoop):
    """One :func:`rollout` call's loop: its buffers, the full-order tick
    and, on a CUDA device, the captured non-solve tick.  The arguments are
    :func:`rollout`'s; ``num_ticks`` sizes the metric rows and bounds the
    ticks a loop can take; ``traced`` also captures the traced graph
    (:mod:`..utils.profiling`'s level 2), which :func:`rollout` asks for
    only while a ``torch.profiler`` records."""

    def __init__(self, robot_b, mpc, gait_b, cmd_b, num_ticks, model_b=None, cp=None,
                 state0=None, carry0=None, solver=ctrl.DEFAULT_SOLVER, spec=None,
                 terrain=None, auto_reset=False, estimator=None, sensor_noise=None, key=None,
                 cmd_ramp_ticks=None, substeps=1, tick0=0, solver_cfg=None, traced=True):
        ctrl.check_solver(solver)
        # The controller's kernels read each parameter's rows in place.
        robot_b, gait_b, cmd_b = (tree_map(torch.Tensor.contiguous, p)
                                  for p in (robot_b, gait_b, cmd_b))
        dev = robot_b.mass.device
        B = robot_b.mass.shape[0]
        if model_b is None:
            one = rbd_model(tree_map(lambda x: x[0], robot_b), spec or mjcf.aliengo_spec())
            model_b = tile(one, B)
        cp = ContactParams.default(dev) if cp is None else cp
        if state0 is None:
            state0 = (init_state_on_terrain(robot_b, terrain, cp.foot_radius)
                      if terrain is not None else default_init_state(robot_b, cp.foot_radius))
        self.use_kf = estimator is not None
        if self.use_kf:
            sensor_noise = srb_env.SensorNoise.default(dev) if sensor_noise is None else sensor_noise
            key = 0 if key is None else key
        if self.use_kf and isinstance(carry0, tuple):
            full0 = carry0                       # a resumed full carry
        else:
            full0 = init_full_carry(robot_b, mpc, state0, cp, carry0, estimator, terrain)
        self.robot, self.mpc, self.gait, self.cmd = robot_b, mpc, gait_b, cmd_b
        self.model, self.cp, self.terrain = model_b, cp, terrain
        self.solver, self.solver_cfg = solver, dict(solver_cfg or {})
        self.auto_reset, self.estimator, self.sensor_noise = auto_reset, estimator, sensor_noise
        self.cmd_ramp_ticks, self.substeps = cmd_ramp_ticks, int(substeps)
        self.tick0, self.num_ticks = int(tick0), int(num_ticks)
        self.dt = mpc.dt_control.to(dev)
        self.sub_dt = self.dt / torch.tensor(float(self.substeps), dtype=torch.float32,
                                             device=dev)
        self.state0, self.carry0 = state0, full0
        self.draws = (srb_env.sensor_draws(key, self.tick0, self.num_ticks, B, dev)
                      if self.use_kf else None)
        keys = ["vel_err", "height", "upright", "diverged"]
        if self.use_kf:
            keys += ["est_pos_err", "est_vel_err"]
        self._start(state0, full0, keys, B, dev, traced)

    def _integrate(self, state, tau):
        """The tick's physics: one step at dt, or ``substeps`` steps at
        dt/substeps under the held torque, reporting the substeps' mean
        contact force (the tick's contact impulse over dt).  Span
        ``tick.plant``, over every substep."""
        step = lambda s, dt: physics_step(self.model, self.robot, self.cp, s, tau, dt,
                                          self.terrain)
        with profiling.span("tick.plant"):
            if self.substeps == 1:
                return step(state, self.dt)
            forces = []
            for _ in range(self.substeps):
                state, f = step(state, self.sub_dt)
                forces.append(f)
            return state, torch.stack(forces).mean(dim=0)

    def _compute(self, state, carry, tick, solve: bool):
        """One closed-loop tick (spans ``tick.controller``, ``tick.plant`` in
        :meth:`_integrate`, ``tick.rows``), as in :mod:`.srb_env`."""
        robot, mpc = self.robot, self.mpc
        B = robot.mass.shape[0]
        with profiling.span("tick.controller"):
            if self.use_kf:
                c_carry, kf_state, prev_vworld, prev_f_feet = carry
                # IMU and encoders from the articulated state.  The specific
                # force is the trunk acceleration plus g in the body frame: the
                # difference of the world velocity over the last step.
                R = lie.quat_to_rotmat(state.quat)
                vworld = (R @ state.u[:, 3:6, None])[..., 0]
                acc = (vworld - prev_vworld) / self.dt
                acc = torch.cat([acc[:, :2], acc[:, 2:] + mpc.gravity], dim=-1)
                a_spec = (R.transpose(-1, -2) @ acc[..., None])[..., 0]
                idx = (tick - self.tick0).long().reshape(1)
                eps = self.draws.index_select(0, idx)[0]
                noise = self.sensor_noise
                gyro = state.u[:, :3] + noise.gyro * eps[:, 0:3]
                accel = a_spec + noise.accel * eps[:, 3:6]
                q_m = state.q + noise.encoder_q * eps[:, 6:18]
                qd_m = state.u[:, 6:] + noise.encoder_qd * eps[:, 18:30]
                # Measured contact: the normal force of the last physics step.
                touch = (prev_f_feet[:, :, 2] > 1.0).float()
                kf_state = kf.update(kf_state, robot, gyro, accel, q_m, qd_m, touch,
                                     self.estimator)
                obs = kf.to_obs(kf_state, gyro, q_m, qd_m)
            else:
                c_carry = carry
                obs = observe(robot, state)
            cmd = (self.cmd if self.cmd_ramp_ticks is None
                   else self.cmd.ramped(tick, self.cmd_ramp_ticks))
            c_carry, out = ctrl.step_gated(robot, mpc, self.gait, cmd, c_carry, obs, tick, solve,
                                           self.solver, **self.solver_cfg)
        state, f_feet = self._integrate(state, out.torques)
        with profiling.span("tick.rows"):
            ground_b = _ground(self.terrain, state.pos[:, None, :])[:, 0]

            bad = _diverged(state, ground_b)
            # The carry holds the pre-step world velocity: next tick's difference
            # spans this tick's physics step.
            new_carry = (c_carry, kf_state, vworld, f_feet) if self.use_kf else c_carry
            if self.auto_reset:
                pick = lambda a, b: tree_map(
                    lambda x, y: torch.where(bad.reshape((B,) + (1,) * (x.dim() - 1)), x, y), a, b)
                state = pick(self.state0, state)
                new_carry = pick(self.carry0, new_carry)

            R = lie.quat_to_rotmat(state.quat)
            v_world = (R @ state.u[:, 3:6, None])[..., 0]
            vel_des = (R @ cmd.vel_base_des[..., None])[..., 0]
            row = {
                "vel_err": torch.linalg.vector_norm(v_world[:, :2] - vel_des[:, :2], dim=-1),
                "height": state.pos[:, 2],
                "upright": R[:, 2, 2],
                "diverged": bad,
            }
            if self.use_kf:
                est = new_carry[1]
                row["est_pos_err"] = torch.linalg.vector_norm(est.x[:, 0:3] - state.pos, dim=-1)
                row["est_vel_err"] = torch.linalg.vector_norm(est.x[:, 3:6] - v_world, dim=-1)
        return state, new_carry, row


def rollout(
    robot_b: RobotParams,
    mpc: MpcParams,
    gait_b: GaitParams,
    cmd_b: Command,
    num_ticks: int,
    model_b: rbd.RbdModel | None = None,
    cp: ContactParams | None = None,
    state0: FullOrderState | None = None,
    carry0=None,
    solver: str = ctrl.DEFAULT_SOLVER,
    spec: mjcf.MjcfSpec | None = None,
    terrain: terrain_lib.Terrain | None = None,
    auto_reset: bool = False,
    estimator: kf.KfParams | None = None,
    sensor_noise: srb_env.SensorNoise | None = None,
    key: int | None = None,
    cmd_ramp_ticks: int | None = None,
    substeps: int = 1,
    tick0: int = 0,
    solver_cfg: dict | None = None,
    return_full_carry: bool = False,
):
    """Batched closed-loop torque-driven rollout of ``num_ticks`` ticks.

    Every robot, gait and command leaf carries a leading scenario axis.
    ``model_b`` defaults to the dynamic model of the first robot and
    ``spec`` (default Aliengo's), tiled over the batch; ``cp`` to
    ``ContactParams.default``; ``state0`` to the nominal stance (on the
    terrain, with ``terrain``); ``carry0`` to a fresh controller carry.

    - ``terrain``: batched heightfield; contact reads the support height
      under each foot;
    - ``auto_reset``: a diverged scenario snaps back to ``state0`` and its
      initial carry (off by default, as in the JAX package);
    - ``cmd_ramp_ticks``: linear command spin-up (``Command.ramped``);
    - ``estimator`` (``kf.KfParams``): the controller runs on the two-stage
      filter fed by noisy IMU and encoder readings (``sensor_noise``,
      default ``SensorNoise.default()``), its leg odometry gated by
      measured contact (normal force of the last step > 1 N); ``key`` is
      an int seed: the noise of each tick is drawn from (seed, absolute
      tick) by ``srb_env.sensor_draws``, gyro 3, accel 3, q 12, qd 12;
    - ``substeps``: the physics steps ``substeps`` times at
      dt/substeps under the held torque, and reports the mean force;
    - ``tick0``: the absolute tick of the first tick (chunked runs);
    - ``solver_cfg``: ``ipm_cfg`` / ``admm_cfg`` / ``admm_fast_cfg`` /
      ``riccati_cfg`` for :func:`controller.step_gated`.

    Returns ``((final_state, final_carry), metrics)``: the controller carry
    (or, with ``return_full_carry``, the full loop carry of
    :func:`init_full_carry`) and a dict of (num_ticks, B) tensors
    ``vel_err``, ``height``, ``upright``, ``diverged`` and, with the
    estimator, ``est_pos_err`` and ``est_vel_err``.  Chunked runs resume
    bit for bit: pass the last chunk's state as ``state0``, its carry as
    ``carry0`` (in estimator mode its full carry) and its end as ``tick0``.

    On a CUDA device the non-solve ticks replay one captured CUDA graph
    (:class:`RolloutLoop`); a capture or replay failure raises."""
    loop = RolloutLoop(robot_b, mpc, gait_b, cmd_b, num_ticks, model_b, cp, state0, carry0,
                       solver, spec, terrain, auto_reset, estimator, sensor_noise, key,
                       cmd_ramp_ticks, substeps, tick0, solver_cfg,
                       traced=profiling.recording())
    for _ in range(num_ticks):
        loop.step()
    return loop.result(return_full_carry)
