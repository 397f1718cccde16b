"""Friction-cone structure (port of ``ops/qp/cones.py``; the slice needs
only the stance variable mask — the IPM block constraints wait for the
condensed path, ROADMAP Queue 1 item 8)."""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.models.mpc import MpcParams


def variable_mask(gait_table: torch.Tensor, mpc: MpcParams) -> torch.Tensor:
    """(..., 12h) 1.0 for stance-controlled force components, 0.0 for swing."""
    return torch.repeat_interleave(gait_table, 3, dim=-1)
