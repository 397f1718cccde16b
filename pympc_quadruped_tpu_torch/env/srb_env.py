"""Batched single-rigid-body rollout environment (port of ``env/srb_env.py``).

The trunk is one rigid body forced by the MPC's ground-reaction forces;
stance feet stay pinned where they touched down, swing feet follow the
controller's targets kinematically (never below the ground), and joint
measurements are synthesized by closed-form IK, or as noisy IMU and encoder
readings for the Kalman filter.  Every function takes a leading scenario
axis.

:func:`rollout` is the closed loop.  JAX runs it as one compiled
``lax.scan``; here, on a CUDA device, the non-solve tick is captured once
per call as a ``torch.cuda.CUDAGraph`` over static state, carry, noise and
metric buffers and a device tick counter, and replayed on every tick where
``tick % iterations_between_mpc != 0`` (:class:`.graph_loop.GraphLoop`, which
the full-order env shares).  The solve tick runs eagerly behind
a host ``if`` (JAX's scalar ``lax.cond``), so the solver kernels launch, and
count, outside the graph.  On CPU inputs the same tick function runs
eagerly on every tick.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.control import ctrl_cuda
from pympc_quadruped_tpu_torch.env import terrain as terrain_lib
from pympc_quadruped_tpu_torch.env.graph_loop import GraphLoop
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.models.command import Command
from pympc_quadruped_tpu_torch.models.gaits import GaitParams
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import gaitsched, kin, lie
from pympc_quadruped_tpu_torch.tree import tile, tree_map
from pympc_quadruped_tpu_torch.utils import profiling


@dataclass
class SrbState:
    """World-frame rigid-body state + foot bookkeeping (per scenario)."""

    pos: torch.Tensor        # (3,)
    quat: torch.Tensor       # (4,) wxyz
    vel: torch.Tensor        # (3,) world
    omega_body: torch.Tensor # (3,) body frame
    foot_pos: torch.Tensor   # (4,3) world; stance feet pinned here
    foot_vel: torch.Tensor   # (4,3) world foot velocity; zero for stance feet


def default_init_state(robot: RobotParams) -> SrbState:
    """Nominal stance (ref mujoco_aliengo.py:32-39), for a robot with any
    leading scenario axes."""
    lead = robot.mass.shape
    f32 = dict(dtype=torch.float32, device=robot.mass.device)
    q0 = torch.tensor([0.0, 0.8, -1.6], **f32).repeat(4, 1).expand(lead + (4, 3))
    p_bf, _ = kin.leg_forward_kinematics(robot, q0)
    zero = torch.zeros(lead, **f32)
    pos = torch.stack([zero, zero, robot.base_height_des], dim=-1)
    feet = pos[..., None, :] + p_bf
    feet = torch.cat([feet[..., :2], torch.zeros_like(feet[..., 2:])], dim=-1)
    return SrbState(
        pos=pos,
        quat=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).expand(lead + (4,)).clone(),
        vel=torch.zeros(lead + (3,), **f32),
        omega_body=torch.zeros(lead + (3,), **f32),
        foot_pos=feet,
        foot_vel=torch.zeros(lead + (4, 3), **f32),
    )


def observe(robot: RobotParams, state: SrbState) -> kin.RobotObs:
    """Synthesize the controller's observation from SRB state via IK:
    J qdot = R^T (v_foot - v_base) - omega_b x p_bf.  On float32 CUDA
    operands one launch of the ``srb_observe`` kernel."""
    if ctrl_cuda.engages(robot, state):
        return ctrl_cuda.srb_observe(robot, state)
    R = lie.quat_to_rotmat(state.quat)
    p_bf = (state.foot_pos - state.pos[..., None, :]) @ R
    q_legs = kin.leg_inverse_kinematics(robot, p_bf)
    _, J = kin.leg_forward_kinematics(robot, q_legs)
    v_rel = (state.foot_vel - state.vel[..., None, :]) @ R - torch.linalg.cross(
        state.omega_body[..., None, :].expand_as(p_bf), p_bf, dim=-1
    )
    qdot_legs = lie.solve3(J, v_rel)
    lead = state.pos.shape[:-1]
    return kin.RobotObs(
        pos_base=state.pos,
        lin_vel_base=state.vel,
        quat_base=state.quat,
        ang_vel_base=state.omega_body,
        q=q_legs.reshape(lead + (12,)),
        qdot=qdot_legs.reshape(lead + (12,)),
    )


@dataclass
class RawSensors:
    """IMU + encoder feed (ref ``scripts/mujoco_aliengo.py:101-118``)."""

    quat: torch.Tensor   # (4,) wxyz orientation (IMU fusion output)
    gyro: torch.Tensor   # (3,) body-frame angular velocity
    accel: torch.Tensor  # (3,) body-frame specific force (includes +g at rest)
    q: torch.Tensor      # (12,) joint encoders
    qdot: torch.Tensor   # (12,)


@dataclass
class SensorNoise:
    """Standard deviations of the sensor noise (0-d tensors)."""

    gyro: torch.Tensor
    accel: torch.Tensor
    encoder_q: torch.Tensor
    encoder_qd: torch.Tensor

    @staticmethod
    def default(device="cuda") -> "SensorNoise":
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return SensorNoise(gyro=f(0.01), accel=f(0.05), encoder_q=f(0.001),
                           encoder_qd=f(0.02))

    @staticmethod
    def zero(device="cuda") -> "SensorNoise":
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return SensorNoise(gyro=f(0.0), accel=f(0.0), encoder_q=f(0.0), encoder_qd=f(0.0))


#: Standard-normal draws per scenario and tick: gyro 3, accel 3, q 12, qdot 12.
NOISE_DRAWS = 30


def _sensors_from_draws(robot, state, forces, eps, noise: SensorNoise) -> RawSensors:
    """Noisy readings from standard-normal draws ``eps`` (...,30)."""
    R = lie.quat_to_rotmat(state.quat)
    lead = forces.shape[:-1]
    f_sum = forces.reshape(lead + (4, 3)).sum(dim=-2) / robot.mass[..., None]
    a_spec = (R.transpose(-1, -2) @ f_sum[..., None])[..., 0]
    truth = observe(robot, state)
    return RawSensors(
        quat=state.quat,
        gyro=state.omega_body + noise.gyro * eps[..., 0:3],
        accel=a_spec + noise.accel * eps[..., 3:6],
        q=truth.q + noise.encoder_q * eps[..., 6:18],
        qdot=truth.qdot + noise.encoder_qd * eps[..., 18:30],
    )


def synthesize_sensors(
    robot: RobotParams,
    state: SrbState,
    forces: torch.Tensor,   # (...,12) world GRFs applied over the last step
    key: torch.Generator,
    noise: SensorNoise,
) -> RawSensors:
    """Noisy IMU + encoder readings from the SRB state, with the noise drawn
    from ``key`` (a generator on the state's device).

    The accelerometer reports specific force R^T sum(F)/m: exactly +g on
    the z axis at static stance."""
    eps = torch.randn(forces.shape[:-1] + (NOISE_DRAWS,), generator=key,
                      dtype=torch.float32, device=forces.device)
    return _sensors_from_draws(robot, state, forces, eps, noise)


def sensor_draws(seed: int, tick0: int, num_ticks: int, batch: int, device,
                 rows: tuple[int, int] | None = None) -> torch.Tensor:
    """(num_ticks, batch, 30) standard-normal draws of the rollout's sensor
    noise: tick ``tick0 + i``'s draws come from a generator seeded by
    (``seed``, absolute tick), so a chunked run resumes bitwise.

    ``rows = (first, global_batch)`` makes them the rows ``[first, first +
    batch)`` of a global batch's draws: each tick draws all
    ``global_batch`` rows and keeps these, so a rank of a sharded sweep
    gets the noise its scenarios have in the unsharded run."""
    first, total = (0, batch) if rows is None else rows
    out = torch.empty((num_ticks, batch, NOISE_DRAWS), dtype=torch.float32, device=device)
    full = None if total == batch else torch.empty((total, NOISE_DRAWS), dtype=torch.float32,
                                                   device=device)
    gen = torch.Generator(device=device)
    for i in range(num_ticks):
        gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | ((tick0 + i) & 0xFFFFFFFF))
        if full is None:
            torch.randn((batch, NOISE_DRAWS), generator=gen, out=out[i])
        else:
            torch.randn((total, NOISE_DRAWS), generator=gen, out=full)
            out[i].copy_(full[first:first + batch])
    return out


def init_state_on_terrain(robot: RobotParams, terrain: terrain_lib.Terrain) -> SrbState:
    """Nominal stance with the feet settled on the local ground surface."""
    s = default_init_state(robot)
    gz = terrain_lib.height_at(terrain, s.foot_pos[..., :2])
    feet = torch.cat([s.foot_pos[..., :2], gz[..., None]], dim=-1)
    pos = torch.cat([s.pos[..., :2], s.pos[..., 2:] + gz.mean(dim=-1, keepdim=True)], dim=-1)
    return dataclasses.replace(s, pos=pos, foot_pos=feet)


def physics_step(
    robot: RobotParams,
    mpc: MpcParams,
    state: SrbState,
    forces: torch.Tensor,          # (...,12) world GRFs (stance legs)
    swing_states: torch.Tensor,    # (...,4)
    swing_pos_world: torch.Tensor, # (...,4,3) desired world swing-foot positions
    terrain: terrain_lib.Terrain | None = None,
) -> SrbState:
    """Semi-implicit Euler at dt_control; swing feet follow their targets
    and never go below the ground: z = 0, or the terrain's surface, where a
    foot that strikes a riser early touches down and is pinned there."""
    dt = mpc.dt_control
    lead = forces.shape[:-1]
    f = forces.reshape(lead + (4, 3))
    stance = (swing_states == 0.0)[..., None]
    f = torch.where(stance, f, torch.zeros_like(f))

    total_f = f.sum(dim=-2)
    acc = total_f / robot.mass[..., None]
    acc = torch.cat([acc[..., :2], acc[..., 2:] - mpc.gravity], dim=-1)

    R = lie.quat_to_rotmat(state.quat)
    RT = R.transpose(-1, -2)
    r_world = state.foot_pos - state.pos[..., None, :]
    torque_world = torch.linalg.cross(r_world, f, dim=-1).sum(dim=-2)
    I_world = R @ robot.inertia @ RT
    omega_world = (R @ state.omega_body[..., None])[..., 0]
    Iw = (I_world @ omega_world[..., None])[..., 0]
    domega_world = lie.solve3(
        I_world, torque_world - torch.linalg.cross(omega_world, Iw, dim=-1)
    )
    omega_world = omega_world + dt * domega_world
    omega_body = (RT @ omega_world[..., None])[..., 0]

    vel = state.vel + dt * acc
    pos = state.pos + dt * vel
    quat = lie.quat_integrate(state.quat, omega_body, dt)

    if terrain is not None:
        ground = terrain_lib.height_at(terrain, swing_pos_world[..., :2])
        swing_z = torch.maximum(swing_pos_world[..., 2], ground)[..., None]
    else:
        swing_z = torch.clamp(swing_pos_world[..., 2:], min=0.0)
    swing_pos_world = torch.cat([swing_pos_world[..., :2], swing_z], dim=-1)
    new_feet = torch.where(stance, state.foot_pos, swing_pos_world)
    new_foot_vel = torch.where(
        stance, torch.zeros_like(new_feet), (new_feet - state.foot_pos) / dt
    )
    return SrbState(pos=pos, quat=quat, vel=vel, omega_body=omega_body,
                    foot_pos=new_feet, foot_vel=new_foot_vel)


def _diverged(state: SrbState) -> torch.Tensor:
    """(B,) divergence flags: non-finite state or implausible base pose."""
    finite = (
        torch.isfinite(state.pos).all(dim=-1)
        & torch.isfinite(state.vel).all(dim=-1)
        & torch.isfinite(state.quat).all(dim=-1)
        & torch.isfinite(state.omega_body).all(dim=-1)
        & torch.isfinite(state.foot_pos).all(dim=-1).all(dim=-1)
        & torch.isfinite(state.foot_vel).all(dim=-1).all(dim=-1)
    )
    rel_h = state.pos[:, 2] - state.foot_pos[:, :, 2].mean(dim=-1)
    plausible = (rel_h > 0.05) & (rel_h < 1.0) & (
        torch.linalg.vector_norm(state.vel, dim=-1) < 10.0
    )
    return ~(finite & plausible)


def init_full_carry(
    robot: RobotParams,
    mpc: MpcParams,
    init_state: SrbState,
    estimator: kf.KfParams | None = None,
):
    """The rollout's full loop carry at tick 0.

    Truth mode: the batched controller carry.  Estimator mode: the tuple
    ``(controller_carry, kf_state, held_forces)``; the held forces seed the
    synthesized accelerometer with standstill gravity support.  Chunked runs
    pass it as ``carry_in`` to resume bitwise."""
    B = robot.mass.shape[0]
    carry0 = tile(ctrl.init_carry(mpc.horizon, device=robot.mass.device), B)
    if estimator is None:
        return carry0
    kf0 = kf.KfState.init(init_state.pos, init_state.foot_pos)
    w0 = robot.mass * mpc.gravity / 4.0
    forces0 = torch.zeros((B, 4, 3), dtype=torch.float32, device=robot.mass.device)
    forces0[:, :, 2] = w0[:, None]
    return (carry0, kf0, forces0.reshape(B, 12))


class RolloutLoop(GraphLoop):
    """One :func:`rollout` call's loop (:class:`..graph_loop.GraphLoop`): its
    buffers, the SRB tick function and, on a CUDA device, the captured
    non-solve tick.

    :meth:`step` advances one tick: a solve tick (host gate) runs eagerly,
    any other tick replays the graph (or runs eagerly on the CPU).  The
    arguments are :func:`rollout`'s; ``num_ticks`` sizes the metric rows
    and bounds the ticks a loop can take; ``traced`` also captures the
    traced graph (:mod:`..utils.profiling`'s level 2), which :func:`rollout`
    asks for only while a ``torch.profiler`` records."""

    def __init__(self, robot, mpc, gait, cmd, num_ticks, init_state=None,
                 solver=ctrl.DEFAULT_SOLVER, terrain=None, auto_reset=True, estimator=None,
                 sensor_noise=None, key=None, carry_in=None, tick0=0, cmd_ramp_ticks=None,
                 contact_source="plan", solver_cfg=None, noise_rows=None, traced=True):
        ctrl.check_solver(solver)
        if contact_source not in ("plan", "measured"):
            raise ValueError(f"unknown contact_source {contact_source!r}")
        # The controller's kernels read each parameter's rows in place.
        robot, gait, cmd = (tree_map(torch.Tensor.contiguous, p) for p in (robot, gait, cmd))
        dev = robot.mass.device
        B = robot.mass.shape[0]
        if init_state is None:
            init_state = (init_state_on_terrain(robot, terrain) if terrain is not None
                          else default_init_state(robot))
        self.use_kf = estimator is not None
        if self.use_kf:
            sensor_noise = SensorNoise.default(dev) if sensor_noise is None else sensor_noise
            key = 0 if key is None else key
        self.robot, self.mpc, self.gait, self.cmd = robot, mpc, gait, cmd
        self.solver, self.solver_cfg = solver, dict(solver_cfg or {})
        self.terrain, self.auto_reset = terrain, auto_reset
        self.estimator, self.sensor_noise = estimator, sensor_noise
        self.cmd_ramp_ticks, self.contact_source = cmd_ramp_ticks, contact_source
        self.tick0, self.num_ticks = int(tick0), int(num_ticks)

        self.init_state = init_state
        self.carry0 = init_full_carry(robot, mpc, init_state, estimator)
        start = self.carry0 if carry_in is None else carry_in
        self.draws = (sensor_draws(key, self.tick0, self.num_ticks, B, dev, noise_rows)
                      if self.use_kf else None)
        keys = ["vel_err", "height", "upright", "diverged"]
        if self.use_kf:
            keys += ["est_pos_err", "est_vel_err"]
            if contact_source == "measured":
                keys.append("contact_mismatch")
        self._start(init_state, start, keys, B, dev, traced)

    def _compute(self, state, carry, tick, solve: bool):
        """One closed-loop tick from (state, carry) at the device tick
        ``tick``: returns (state', carry', metric row).  Spans
        ``tick.controller`` (the observation or the estimator, the controller
        and the swing targets), ``tick.plant`` and ``tick.rows`` (divergence,
        auto-reset and the metric row)."""
        robot, mpc, gait = self.robot, self.mpc, self.gait
        B = robot.mass.shape[0]
        with profiling.span("tick.controller"):
            if self.use_kf:
                c_carry, kf_state, held_forces = carry
                idx = (tick - self.tick0).long().reshape(1)
                eps = self.draws.index_select(0, idx)[0]
                sensors = _sensors_from_draws(robot, state, held_forces, eps, self.sensor_noise)
                plan_contact = (gaitsched.swing_state(gait, mpc, tick) == 0.0).float()
                if self.contact_source == "measured":
                    # A touch sensor fires on the held GRF of a pinned foot: it
                    # lags the plan at every stance onset.
                    held_fz = held_forces.reshape(B, 4, 3)[:, :, 2]
                    contact = plan_contact * (held_fz > 1.0).float()
                else:
                    contact = plan_contact
                kf_state = kf.update(kf_state, robot, sensors.gyro, sensors.accel, sensors.q,
                                     sensors.qdot, contact, self.estimator)
                obs = kf.to_obs(kf_state, sensors.gyro, sensors.q, sensors.qdot)
            else:
                c_carry = carry
                obs = observe(robot, state)
            cmd = (self.cmd if self.cmd_ramp_ticks is None
                   else self.cmd.ramped(tick, self.cmd_ramp_ticks))
            c_carry, out = ctrl.step_gated(robot, mpc, gait, cmd, c_carry, obs, tick, solve,
                                           self.solver, **self.solver_cfg)
            # World-frame swing-foot targets, as loop.run_ticks forms them.
            swing_pos_world = state.pos[:, None, :] + (
                out.kin.R_base[:, None] @ out.pos_targets[..., None]
            )[..., 0]
        with profiling.span("tick.plant"):
            state = physics_step(robot, mpc, state, out.contact_forces, out.swing_states,
                                 swing_pos_world, self.terrain)

        with profiling.span("tick.rows"):
            bad = _diverged(state)
            new_carry = (c_carry, kf_state, out.contact_forces) if self.use_kf else c_carry
            if self.auto_reset:
                pick = lambda a, b: tree_map(
                    lambda x, y: torch.where(bad.reshape((B,) + (1,) * (x.dim() - 1)), x, y), a, b)
                state = pick(self.init_state, state)
                new_carry = pick(self.carry0, new_carry)

            vel_des_world = (out.kin.R_base @ cmd.vel_base_des[..., None])[..., 0]
            row = {
                "vel_err": torch.linalg.vector_norm(state.vel - vel_des_world, dim=-1),
                "height": state.pos[:, 2],
                "upright": out.kin.R_base[:, 2, 2],
                "diverged": bad,
            }
            if self.use_kf:
                est = new_carry[1]
                row["est_pos_err"] = torch.linalg.vector_norm(est.x[:, 0:3] - state.pos, dim=-1)
                row["est_vel_err"] = torch.linalg.vector_norm(est.x[:, 3:6] - state.vel, dim=-1)
                if self.contact_source == "measured":
                    row["contact_mismatch"] = (contact - plan_contact).abs().mean(dim=-1)
        return state, new_carry, row


def rollout(
    robot: RobotParams,
    mpc: MpcParams,
    gait: GaitParams,
    cmd: Command,
    num_ticks: int,
    init_state: SrbState | None = None,
    solver: str = ctrl.DEFAULT_SOLVER,
    terrain: terrain_lib.Terrain | None = None,
    auto_reset: bool = True,
    estimator: kf.KfParams | None = None,
    sensor_noise: SensorNoise | None = None,
    key: int | None = None,
    carry_in=None,
    tick0: int = 0,
    return_full_carry: bool = False,
    cmd_ramp_ticks: int | None = None,
    contact_source: str = "plan",
    solver_cfg: dict | None = None,
    noise_rows: tuple[int, int] | None = None,
):
    """Closed-loop batched rollout of ``num_ticks`` ticks.

    Every argument except ``mpc`` carries a leading scenario axis (``robot``,
    ``gait``, ``cmd`` and an optional per-scenario ``terrain`` are
    randomization axes).  Returns ``((env_state, controller_carry),
    metrics)``, metrics a dict of (num_ticks, B) tensors: ``vel_err``,
    ``height``, ``upright`` and ``diverged``.  With ``auto_reset`` a
    diverged scenario snaps back to its initial state and carry.

    ``estimator`` (``kf.KfParams``) drives the controller with the Kalman
    filter on noisy synthesized sensors (``sensor_noise``, default
    ``SensorNoise.default()``) instead of ground truth, and adds
    ``est_pos_err`` and ``est_vel_err``.  ``key`` is an int seed: the noise
    of each tick is drawn from (seed, absolute tick); on a rank of a
    sharded sweep, ``noise_rows = (first row, global batch)`` gives its rows
    the noise they have in the unsharded run (:func:`sensor_draws`).
    ``contact_source`` gates the filter's leg odometry on the planned stance
    (``"plan"``) or on a touch signal from the held GRFs (``"measured"``,
    adding ``contact_mismatch``).

    Chunked runs resume bitwise: pass the previous chunk's env state as
    ``init_state``, its full carry (``return_full_carry=True``, the
    :func:`init_full_carry` structure) as ``carry_in`` and the absolute
    starting tick as ``tick0``.  ``cmd_ramp_ticks`` ramps the command in
    from standstill (:meth:`Command.ramped`); ``solver_cfg`` is a dict of
    ``ipm_cfg`` / ``admm_cfg`` / ``admm_fast_cfg`` / ``riccati_cfg`` for
    :func:`controller.step_gated`.

    On a CUDA device the non-solve ticks replay one captured CUDA graph
    (:class:`RolloutLoop`); a capture or replay failure raises."""
    loop = RolloutLoop(robot, mpc, gait, cmd, num_ticks, init_state, solver, terrain,
                       auto_reset, estimator, sensor_noise, key, carry_in, tick0,
                       cmd_ramp_ticks, contact_source, solver_cfg, noise_rows,
                       traced=profiling.recording())
    for _ in range(num_ticks):
        loop.step()
    return loop.result(return_full_carry)
