"""Robot parameters (port of ``pympc_quadruped_tpu/models/robots.py``).

Physical parameters mirror the reference configs (ref
``config/robot_configs.py:21-56``); leg geometry comes from the reference
URDFs.  Every field is a float32 tensor, so a batch of randomized robots is
this dataclass with a leading scenario axis (:func:`..tree.tile`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# Leg order contract: FL, FR, RL, RR (see the JAX package docstring).
LEG_NAMES = ("FL", "FR", "RL", "RR")
NUM_LEGS = 4
NUM_JOINTS = 12


def _inertia_from_urdf(ixx, ixy, ixz, iyy, iyz, izz):
    """Symmetric 3x3 inertia from the 6 URDF scalars."""
    return [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]


@dataclass
class RobotParams:
    """Physical + leg-geometry parameters for one quadruped; field meanings
    as in the JAX ``RobotParams``."""

    mass: torch.Tensor
    inertia: torch.Tensor
    base_height_des: torch.Tensor
    fz_max: torch.Tensor
    swing_height: torch.Tensor
    kp_swing: torch.Tensor
    kd_swing: torch.Tensor
    hip_offset: torch.Tensor
    hip_len: torch.Tensor
    l_thigh: torch.Tensor
    l_calf: torch.Tensor
    touchdown_z: torch.Tensor


def _leg_layout(front_x: float, side_y: float, hip_len: float):
    """(4,3) hip origins + (4,) signed abduction lengths in FL,FR,RL,RR order."""
    hips = [
        [front_x, side_y, 0.0],
        [front_x, -side_y, 0.0],
        [-front_x, side_y, 0.0],
        [-front_x, -side_y, 0.0],
    ]
    return hips, [hip_len, -hip_len, hip_len, -hip_len]


def _robot(device, inertia_scale: float = 1.0, **fields) -> RobotParams:
    """RobotParams of float32 tensors on ``device`` from plain numbers."""
    t = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in fields.items()}
    t["inertia"] = t["inertia"] * inertia_scale
    return RobotParams(**t)


def aliengo(device="cuda") -> RobotParams:
    """Unitree Aliengo (ref config/robot_configs.py:21-37), on ``device``."""
    hips, hip_len = _leg_layout(0.2399, 0.051, 0.083)
    return _robot(
        device,
        mass=9.042,
        inertia=_inertia_from_urdf(
            ixx=0.033260231, ixy=-0.000451628, ixz=0.000487603,
            iyy=0.16117211, iyz=4.8356e-05, izz=0.17460442,
        ),
        base_height_des=0.38,
        fz_max=500.0,
        swing_height=0.1,
        kp_swing=[200.0] * 3,
        kd_swing=[20.0] * 3,
        hip_offset=hips,
        hip_len=hip_len,
        l_thigh=0.25,
        l_calf=0.25,
        touchdown_z=-0.0255,
    )


def a1(device="cuda") -> RobotParams:
    """Unitree A1 (ref config/robot_configs.py:40-56), on ``device``.

    The reference multiplies the URDF trunk inertia by 10; that is the
    tuning that works, so it is reproduced (ref robot_configs.py:50).
    """
    hips, hip_len = _leg_layout(0.183, 0.047, 0.08505)
    return _robot(
        device,
        mass=4.713,
        inertia=_inertia_from_urdf(
            ixx=0.01683993, ixy=8.3902e-05, ixz=0.000597679,
            iyy=0.056579028, iyz=2.5134e-05, izz=0.064713601,
        ),
        inertia_scale=10.0,
        base_height_des=0.42,
        fz_max=500.0,
        swing_height=0.1,
        kp_swing=[700.0] * 3,
        kd_swing=[20.0] * 3,
        hip_offset=hips,
        hip_len=hip_len,
        l_thigh=0.2,
        l_calf=0.2,
        touchdown_z=-0.0255,
    )
