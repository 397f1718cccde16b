"""Leg torque mapping (port of ``control/legctrl.py``).

Per leg ``tau_leg = J_leg^T R_base^T F_world`` with ``F_world = -f_mpc`` for
stance legs and the world-frame Cartesian PD for swing legs (a leg swings
iff its swing_state is nonzero, ref ``linear_mpc/leg_controller.py:70-91``).
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops.kin import KinState


def leg_torques(
    robot: RobotParams,
    kin: KinState,
    contact_forces: torch.Tensor,
    swing_states: torch.Tensor,
    pos_targets_swingfeet: torch.Tensor,
    vel_targets_swingfeet: torch.Tensor,
) -> torch.Tensor:
    """(...,12) torque command from (...,12) world GRFs, (...,4) swing
    phases and (...,4,3) base-frame swing targets."""
    R = kin.R_base
    RT = R.transpose(-1, -2)
    swinging = (swing_states != 0.0)[..., None]

    pos_err_w = (pos_targets_swingfeet - kin.base_pos_base_feet) @ RT
    vel_err_w = (vel_targets_swingfeet - kin.base_vel_base_feet) @ RT
    f_swing = (robot.kp_swing[..., None, :] * pos_err_w
               + robot.kd_swing[..., None, :] * vel_err_w)

    lead = contact_forces.shape[:-1]
    f_stance = -contact_forces.reshape(lead + (4, 3))
    f_world = torch.where(swinging, f_swing, f_stance)

    f_base = f_world @ R
    tau = (kin.jac_feet * f_base[..., :, None]).sum(dim=-2)      # J^T f per leg
    return tau.reshape(lead + (12,))
