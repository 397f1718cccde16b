"""Single-rigid-body state-space model + exact ZOH (port of ``ops/srb.py``).

State (13): [roll, pitch, yaw, px, py, pz, wx, wy, wz, vx, vy, vz, g];
input (12): world-frame GRFs [f_FL, f_FR, f_RL, f_RR].  ``Ac`` is nilpotent
(Ac^3 = 0), so the ZOH series terminates exactly:

    Ad = I + Ac dt + Ac^2 dt^2 / 2
    Bd = (I dt + Ac dt^2/2 + Ac^2 dt^3/6) Bc

Batched over a leading scenario axis (the JAX functions are per scenario).
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.models.mpc import NUM_INPUT, NUM_STATE, MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import lie


def state_space(robot: RobotParams, yaw: torch.Tensor, pos_base_feet: torch.Tensor):
    """(B,) yaw and (B,4,3) world-frame foot offsets -> Ac (B,13,13), Bc (B,13,12)."""
    Rz = lie.rot_z(yaw)
    RzT = Rz.transpose(-1, -2)
    inertia_world = Rz @ robot.inertia @ RzT
    # Kept as a general inverse on purpose, as in the JAX module
    # (ops/srb.py:55-60): the closed-loop trots are sensitive to the ~1e-7
    # difference an adjugate inverse makes.  ``inv_ex`` runs the kernels of
    # ``inv`` without reading the factorisation's error code on the host, so
    # the solve tick does not wait for the card here; a singular inertia
    # gives non-finite entries in its row, as ``jnp.linalg.inv`` does, and
    # the controller then holds that row's forces.
    inv_inertia, _ = torch.linalg.inv_ex(inertia_world)

    lead = yaw.shape
    Ac = yaw.new_zeros(lead + (NUM_STATE, NUM_STATE))
    Ac[..., 0:3, 6:9] = RzT
    Ac[..., 3:6, 9:12] = torch.eye(3, dtype=yaw.dtype, device=yaw.device)
    Ac[..., 11, 12] = 1.0

    torque_blocks = inv_inertia[..., None, :, :] @ lie.skew(pos_base_feet)  # (B,4,3,3)
    Bc = yaw.new_zeros(lead + (NUM_STATE, NUM_INPUT))
    Bc[..., 6:9, :] = torque_blocks.transpose(-3, -2).reshape(lead + (3, NUM_INPUT))
    inv_m = 1.0 / robot.mass
    for leg in range(4):
        for i in range(3):
            Bc[..., 9 + i, 3 * leg + i] = inv_m
    return Ac, Bc


def discretize(Ac: torch.Tensor, Bc: torch.Tensor, dt: torch.Tensor):
    """Exact ZOH discretization using the terminating nilpotent series."""
    eye = torch.eye(NUM_STATE, dtype=Ac.dtype, device=Ac.device)
    A2 = Ac @ Ac
    Ad = eye + Ac * dt + A2 * (0.5 * dt * dt)
    Bd = (eye * dt + Ac * (0.5 * dt * dt) + A2 * (dt * dt * dt / 6.0)) @ Bc
    return Ad, Bd


def pack_state(rpy, pos, omega, vel, mpc: MpcParams) -> torch.Tensor:
    """(...,13) MPC state; x[12] = -g (ref mpc.py:55-77)."""
    g_slot = (-mpc.gravity).to(rpy.dtype).expand(rpy.shape[:-1] + (1,))
    return torch.cat([rpy, pos, omega, vel, g_slot], dim=-1)
