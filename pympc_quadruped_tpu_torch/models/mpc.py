"""MPC hyper-parameters (port of ``pympc_quadruped_tpu/models/mpc.py``).

Mirrors the reference's ``LinearMpcConfig`` plus its hard-coded prediction
step ``dt_predict = 0.05`` (ref ``linear_mpc/mpc.py:38``), which differs from
``dt_control * iterations_between_mpc = 0.02``: both quirks are kept.

``horizon``, ``iterations_between_mpc`` and ``ground_adaptive_height`` are
static Python values (they set shapes and program branches); every other
field is a float32 tensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from pympc_quadruped_tpu_torch import tree

NUM_STATE = 13   # [roll, pitch, yaw, x, y, z, wx, wy, wz, vx, vy, vz, g]
NUM_INPUT = 12   # [f_FL, f_FR, f_RL, f_RR], world frame


def _f32(v):
    return lambda: torch.tensor(v, dtype=torch.float32)


@dataclass
class MpcParams:
    # --- static (shape-determining) ---
    horizon: int = 16
    iterations_between_mpc: int = 20
    ground_adaptive_height: bool = False
    # --- tensors ---
    dt_control: torch.Tensor = field(default_factory=_f32(0.001))
    dt_predict: torch.Tensor = field(default_factory=_f32(0.05))
    gravity: torch.Tensor = field(default_factory=_f32(9.81))
    friction_coef: torch.Tensor = field(default_factory=_f32(0.7))
    # diag(Q) (ref linear_mpc_configs.py:19); uniform 1e-5 input weight (:20).
    q_diag: torch.Tensor = field(default_factory=_f32(
        [5.0, 5.0, 10.0, 10.0, 10.0, 50.0, 0.01, 0.01, 0.2, 0.2, 0.2, 0.2, 0.0]
    ))
    r_diag: torch.Tensor = field(default_factory=_f32([1.0e-5] * NUM_INPUT))
    # Reference-trajectory shaping constants (ref mpc.py:121,143-150).
    max_pos_error: torch.Tensor = field(default_factory=_f32(0.1))
    comp_saturation: torch.Tensor = field(default_factory=_f32(0.25))

    @property
    def dt_gait(self):
        """Seconds per gait segment, dt_control * iterations_between_mpc
        = 0.02 s (ref gait.py:70-74), while prediction uses dt_predict."""
        return self.dt_control * self.iterations_between_mpc


def default_mpc_params(horizon: int = 16, device="cuda") -> MpcParams:
    """``MpcParams(horizon=horizon)`` with every tensor on ``device``."""
    return tree.to(MpcParams(horizon=horizon), device)
