"""Closed-form quadruped leg kinematics (port of ``ops/kin.py``).

Leg order FL, FR, RL, RR; joints (hip, thigh, calf); ``quat_base`` wxyz;
``ang_vel_base`` the body-frame gyro.  The chain, with signed abduction
length ``s`` and link lengths ``l2, l3``:

    p_base_foot = o_hip + Rx(q1) @ ([0,s,0] + Ry(q2) @ ([0,0,-l2] + Ry(q3) @ [0,0,-l3]))

Functions take any leading scenario axes on both the robot and the
observation (the JAX functions are per scenario).  The reference's
Pinocchio velocity quirk in ``base_vel_base_feet`` is reproduced, as in
the JAX module.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import lie


@dataclass
class RobotObs:
    """Raw per-tick measurements."""

    pos_base: torch.Tensor      # (3,) world
    lin_vel_base: torch.Tensor  # (3,) world
    quat_base: torch.Tensor     # (4,) wxyz
    ang_vel_base: torch.Tensor  # (3,) body-frame gyro
    q: torch.Tensor             # (12,)
    qdot: torch.Tensor          # (12,)


@dataclass
class KinState:
    """Everything the controllers consume, derived from one observation."""

    R_base: torch.Tensor               # (3,3)
    rpy_base: torch.Tensor             # (3,)
    pos_base: torch.Tensor             # (3,)
    lin_vel_base: torch.Tensor         # (3,)
    ang_vel_base: torch.Tensor         # (3,) body frame
    base_pos_base_feet: torch.Tensor   # (4,3) feet rel. base, base frame
    pos_base_feet: torch.Tensor        # (4,3) feet rel. base, world frame
    pos_feet: torch.Tensor             # (4,3) feet, world frame
    base_vel_base_feet: torch.Tensor   # (4,3) foot vel rel. base, base frame
    base_pos_base_thighs: torch.Tensor # (4,3) thigh joints rel. base, base frame
    jac_feet: torch.Tensor             # (4,3,3) d(base_pos_base_foot)/d(q_leg)


# cos(0.1) in f32: the knee never straightens past 0.1 rad, which keeps the
# leg Jacobian invertible for out-of-reach targets.
_COS_KNEE_MAX = float(torch.cos(torch.tensor(0.1, dtype=torch.float32)))


def _mT(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def leg_forward_kinematics(robot: RobotParams, q_legs: torch.Tensor):
    """(...,4,3) joint angles -> ((...,4,3) base-frame feet, (...,4,3,3)
    Jacobians whose columns are d/dq)."""
    q1, q2, q3 = q_legs.unbind(-1)
    s_hip = robot.hip_len
    l2, l3 = robot.l_thigh[..., None], robot.l_calf[..., None]

    c1, s1 = torch.cos(q1), torch.sin(q1)
    c2, s2 = torch.cos(q2), torch.sin(q2)
    c23, s23 = torch.cos(q2 + q3), torch.sin(q2 + q3)

    u = -l2 * s2 - l3 * s23
    w = -l2 * c2 - l3 * c23

    px = u
    py = c1 * s_hip - s1 * w
    pz = s1 * s_hip + c1 * w
    p = robot.hip_offset + torch.stack([px, py, pz], dim=-1)

    zero = torch.zeros_like(q1)
    col1 = torch.stack([zero, -s1 * s_hip - c1 * w, c1 * s_hip - s1 * w], dim=-1)
    col2 = torch.stack([w, s1 * u, -c1 * u], dim=-1)
    col3 = torch.stack([-l3 * c23, -s1 * l3 * s23, c1 * l3 * s23], dim=-1)
    J = torch.stack([col1, col2, col3], dim=-1)
    return p, J


def thigh_positions(robot: RobotParams, q_legs: torch.Tensor) -> torch.Tensor:
    """(...,4,3) thigh-joint origins in the base frame: o_hip + Rx(q1) [0,s,0]."""
    q1 = q_legs[..., 0]
    c1, s1 = torch.cos(q1), torch.sin(q1)
    s_hip = robot.hip_len
    off = torch.stack([torch.zeros_like(q1), c1 * s_hip, s1 * s_hip], dim=-1)
    return robot.hip_offset + off


def leg_inverse_kinematics(robot: RobotParams, p_base_feet: torch.Tensor) -> torch.Tensor:
    """(...,4,3) base-frame feet -> (...,4,3) joint angles, knee-flexed branch
    (knee clipped short of full extension, as in the JAX module)."""
    r = p_base_feet - robot.hip_offset
    s_hip = robot.hip_len
    l2, l3 = robot.l_thigh[..., None], robot.l_calf[..., None]

    ry, rz = r[..., 1], r[..., 2]
    yz_sq = ry * ry + rz * rz
    w_abs = torch.sqrt(torch.clamp(yz_sq - s_hip * s_hip, min=1e-9))
    w = -w_abs
    q1 = torch.atan2(rz, ry) - torch.atan2(w, s_hip)
    q1 = torch.atan2(torch.sin(q1), torch.cos(q1))

    u = r[..., 0]
    d_sq = u * u + w * w
    cos_q3 = torch.clamp(
        (d_sq - l2 * l2 - l3 * l3) / (2.0 * l2 * l3), -1.0, _COS_KNEE_MAX
    )
    q3 = -torch.acos(cos_q3)
    s3, c3 = torch.sin(q3), torch.cos(q3)
    q2 = torch.atan2(-u, -w) - torch.atan2(l3 * s3, l2 + l3 * c3)
    q2 = torch.atan2(torch.sin(q2), torch.cos(q2))
    return torch.stack([q1, q2, q3], dim=-1)


def compute_kin_state(
    robot: RobotParams, obs: RobotObs, pinocchio_vel_quirk: bool = True
) -> KinState:
    """One-tick state ingest (the counterpart of the reference's
    RobotData.update)."""
    R = lie.quat_to_rotmat(obs.quat_base)
    rpy = lie.quat_to_zyx(obs.quat_base)

    lead = obs.q.shape[:-1]
    q_legs = obs.q.reshape(lead + (4, 3))
    qd_legs = obs.qdot.reshape(lead + (4, 3))

    p_bf, J = leg_forward_kinematics(robot, q_legs)
    pos_base_feet = p_bf @ _mT(R)
    pos_feet = obs.pos_base[..., None, :] + pos_base_feet

    rel = torch.linalg.cross(
        obs.ang_vel_base[..., None, :].expand_as(p_bf), p_bf, dim=-1
    ) + (J @ qd_legs[..., None])[..., 0]
    if pinocchio_vel_quirk:
        v = obs.lin_vel_base
        rel = rel + (v - (_mT(R) @ v[..., None])[..., 0])[..., None, :]

    thighs = thigh_positions(robot, q_legs)

    return KinState(
        R_base=R,
        rpy_base=rpy,
        pos_base=obs.pos_base,
        lin_vel_base=obs.lin_vel_base,
        ang_vel_base=obs.ang_vel_base,
        base_pos_base_feet=p_bf,
        pos_base_feet=pos_base_feet,
        pos_feet=pos_feet,
        base_vel_base_feet=rel,
        base_pos_base_thighs=thighs,
        jac_feet=J,
    )
