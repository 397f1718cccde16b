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

    def ramped(self, tick, ramp_ticks) -> "Command":
        """The command scaled by ``min(1, tick/ramp_ticks)``: a linear
        spin-up from standstill.  ``ramp_ticks <= 0`` means no ramp (scale
        1), and the safe divisor keeps a fractional ramp in (0, 1) scaling
        by tick/ramp.  ``tick`` is a Python int or a 0-d tensor on the
        command's device (a device tick keeps the scale on the device)."""
        ramp = float(torch.tensor(ramp_ticks, dtype=torch.float32))  # JAX's f32 rounding
        if ramp <= 0.0:
            return self
        if not isinstance(tick, torch.Tensor):
            tick = torch.tensor(tick)              # a 0-d CPU scalar joins any device
        s = torch.clamp(tick.float() / ramp, 0.0, 1.0)
        return Command(vel_base_des=self.vel_base_des * s,
                       yaw_turn_rate=self.yaw_turn_rate * s)
