"""Velocity command (port of ``pympc_quadruped_tpu/models/command.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Command:
    """Desired base velocity in the base frame + yaw turn rate [rad/s]."""

    vel_base_des: torch.Tensor   # (3,) m/s, base frame
    yaw_turn_rate: torch.Tensor  # scalar rad/s

    @staticmethod
    def trot_forward(vx: float = 1.2, device="cuda") -> "Command":
        f32 = dict(dtype=torch.float32, device=device)
        return Command(
            vel_base_des=torch.tensor([vx, 0.0, 0.0], **f32),
            yaw_turn_rate=torch.tensor(0.0, **f32),
        )
