"""Batched single-rigid-body physics (port of ``env/srb_env.py``).

The trunk is one rigid body forced by the MPC's ground-reaction forces;
stance feet stay pinned where they touched down, swing feet follow the
controller's targets kinematically, and joint measurements are synthesized
by closed-form IK.  Every function takes a leading scenario axis.  Ported so
far: the flat-world tick (:func:`observe`, :func:`physics_step`) and the
divergence test; ``rollout``, sensors, the Kalman filter and terrain wait
(ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import kin, lie


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
    J qdot = R^T (v_foot - v_base) - omega_b x p_bf."""
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


def physics_step(
    robot: RobotParams,
    mpc: MpcParams,
    state: SrbState,
    forces: torch.Tensor,          # (...,12) world GRFs (stance legs)
    swing_states: torch.Tensor,    # (...,4)
    swing_pos_world: torch.Tensor, # (...,4,3) desired world swing-foot positions
    terrain=None,
) -> SrbState:
    """Semi-implicit Euler at dt_control on flat ground; swing feet follow
    their targets and never go below z = 0."""
    if terrain is not None:
        raise NotImplementedError("terrain is not ported yet (ROADMAP Queue 1, item 7)")
    dt = mpc.dt_control
    lead = forces.shape[:-1]
    f = forces.reshape(lead + (4, 3))
    stance = (swing_states == 0.0)[..., None]
    f = torch.where(stance, f, torch.zeros_like(f))

    total_f = f.sum(dim=-2)
    e_z = torch.tensor([0.0, 0.0, 1.0], dtype=f.dtype, device=f.device)
    acc = total_f / robot.mass[..., None] - e_z * mpc.gravity

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
