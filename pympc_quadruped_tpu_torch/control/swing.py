"""Swing-foot trajectory generation (port of ``control/swing.py``).

Closed-form two-segment cubic Hermite swing (zero knot velocities), the
reference's Raibert-style foothold, and per-leg latches in an explicit
:class:`SwingCarry`, updated with masks so all legs of all scenarios
advance together (ref ``linear_mpc/swing_foot_trajectory_generator.py``).
Both ``ground_adaptive_height`` branches are ported; they are static.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.models.command import Command
from pympc_quadruped_tpu_torch.models.gaits import GaitParams
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import gaitsched, lie
from pympc_quadruped_tpu_torch.ops.kin import KinState


@dataclass
class SwingCarry:
    """Per-leg swing latches (shapes (4,) / (4,3) per scenario)."""

    is_first_swing: torch.Tensor        # bool (4,)
    remaining_swing_time: torch.Tensor  # (4,)
    footpos_init: torch.Tensor          # (4,3) world
    footpos_final: torch.Tensor         # (4,3) world

    @staticmethod
    def init(device="cuda") -> "SwingCarry":
        f32 = dict(dtype=torch.float32, device=device)
        return SwingCarry(
            is_first_swing=torch.ones(4, dtype=torch.bool, device=device),
            remaining_swing_time=torch.zeros(4, **f32),
            footpos_init=torch.zeros((4, 3), **f32),
            footpos_final=torch.zeros((4, 3), **f32),
        )


def _hermite_eval(p0, p1, duration, t):
    """Cubic Hermite segment with zero endpoint velocities, elementwise over
    legs: p0, p1 (...,4,3); duration, t broadcastable to (...,4)."""
    u = torch.clamp(t / duration, 0.0, 1.0)
    blend = u * u * (3.0 - 2.0 * u)
    dblend = 6.0 * u * (1.0 - u) / duration
    diff = p1 - p0
    return p0 + blend[..., None] * diff, dblend[..., None] * diff


def _set_z(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.cat([p[..., :2], z[..., None].expand(p.shape[:-1] + (1,))], dim=-1)


def update_swing(
    robot: RobotParams,
    mpc: MpcParams,
    gait: GaitParams,
    cmd: Command,
    kin: KinState,
    carry: SwingCarry,
    swing_states: torch.Tensor,
):
    """Advance all four legs one tick, batched over scenarios.

    Returns (carry', pos_targets (...,4,3), vel_targets (...,4,3)): base-frame
    targets relative to the base, zero for stance legs."""
    active = swing_states > 0.0
    t_stance = gaitsched.stance_time(gait, mpc)[..., None]          # (...,1)
    t_swing = gaitsched.swing_time(gait, mpc)[..., None]
    R = kin.R_base
    RT = R.transpose(-1, -2)
    vel_des_world = (R @ cmd.vel_base_des[..., None])[..., 0]

    # --- placement (ref :84-129) ---
    remaining = torch.where(
        carry.is_first_swing,
        t_swing.expand_as(carry.remaining_swing_time),
        carry.remaining_swing_time - mpc.dt_control,
    )
    remaining = torch.where(active, remaining, carry.remaining_swing_time)

    rot_yaw = lie.rot_z(cmd.yaw_turn_rate * 0.5 * t_stance[..., 0])
    thigh_corr = kin.base_pos_base_thighs @ rot_yaw.transpose(-1, -2)

    foothold = (
        kin.pos_base[..., None, :]
        + (thigh_corr + cmd.vel_base_des[..., None, :] * remaining[..., None]) @ RT
        + 0.5 * t_stance[..., None] * kin.lin_vel_base[..., None, :]
        + 0.03 * (kin.lin_vel_base - vel_des_world)[..., None, :]
    )
    yr = cmd.yaw_turn_rate
    centripetal = (0.5 * kin.pos_base[..., 2] / mpc.gravity)[..., None] * torch.stack(
        [kin.lin_vel_base[..., 1] * yr, -kin.lin_vel_base[..., 0] * yr,
         torch.zeros_like(yr)], dim=-1,
    )
    foothold = foothold + centripetal[..., None, :]

    footpos_init = torch.where(
        (active & carry.is_first_swing)[..., None], kin.pos_feet, carry.footpos_init
    )
    if mpc.ground_adaptive_height:
        # Touchdown measured from the leg's own lift-off ground sample.
        foothold = _set_z(foothold, footpos_init[..., 2] + robot.touchdown_z[..., None])
    else:
        foothold = _set_z(foothold, robot.touchdown_z[..., None])

    footpos_final = torch.where(active[..., None], foothold, carry.footpos_final)
    is_first = torch.where(active, torch.zeros_like(active), carry.is_first_swing)
    is_first = torch.where(active & (swing_states >= 1.0), torch.ones_like(active), is_first)

    # --- trajectory evaluation (ref :38-82) ---
    cur_t = t_swing - remaining
    half = t_swing * 0.5
    mid = 0.5 * (footpos_init + footpos_final)
    if mpc.ground_adaptive_height:
        # Apex clearance above the higher of lift-off/touchdown samples.
        mid = _set_z(mid, torch.maximum(footpos_init[..., 2], footpos_final[..., 2])
                     + robot.swing_height[..., None])
    else:
        mid = _set_z(mid, robot.swing_height[..., None])
    p_a, v_a = _hermite_eval(footpos_init, mid, half, cur_t)
    p_b, v_b = _hermite_eval(mid, footpos_final, half, cur_t - half)
    in_first = (cur_t < half)[..., None]
    pos_world = torch.where(in_first, p_a, p_b)
    vel_world = torch.where(in_first, v_a, v_b)

    pos_rel_base = (pos_world - kin.pos_base[..., None, :]) @ R
    vel_rel_base = (vel_world - kin.lin_vel_base[..., None, :]) @ R

    zero = torch.zeros_like(pos_rel_base)
    pos_targets = torch.where(active[..., None], pos_rel_base, zero)
    vel_targets = torch.where(active[..., None], vel_rel_base, zero)

    new_carry = SwingCarry(
        is_first_swing=is_first,
        remaining_swing_time=remaining,
        footpos_init=footpos_init,
        footpos_final=footpos_final,
    )
    return new_carry, pos_targets, vel_targets
