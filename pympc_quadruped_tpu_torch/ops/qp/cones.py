"""Friction-cone structure of the condensed MPC QP (port of
``ops/qp/cones.py``), batched over a leading scenario axis.

Every (step, leg) block owns a 3-vector of forces constrained by
``|fx| <= mu fz, |fy| <= mu fz, 0 <= fz <= fz_max`` on stance legs.  Swing
legs are pinned instead of constrained: their cost becomes an identity
quadratic with zero gradient (optimum exactly 0) and their cone rows the
trivially inactive ``0 <= 1``, so shapes stay static whatever legs swing.
The per-block ``block_matvec``/``block_normal_matrix`` helpers serve only
the IPM and wait for it (ROADMAP Queue 1, item 9).
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.models.mpc import MpcParams

CONE_ROWS_PER_BLOCK = 6


def _cone_rows(mu: torch.Tensor) -> torch.Tensor:
    """(6,3) stance-block constraint rows of G f <= h."""
    one, zero = torch.ones_like(mu), torch.zeros_like(mu)
    return torch.stack([
        torch.stack([-one, zero, -mu]),
        torch.stack([one, zero, -mu]),
        torch.stack([zero, -one, -mu]),
        torch.stack([zero, one, -mu]),
        torch.stack([zero, zero, -one]),
        torch.stack([zero, zero, one]),
    ])


def block_constraints(gait_table: torch.Tensor, fz_max, mpc: MpcParams):
    """Per-block constraint tensors from the (B,4h) stance table.

    Returns G (B,h,4,6,3) rows (zero on swing blocks), h_vec (B,h,4,6)
    right-hand sides, stance (B,h,4).  ``fz_max`` is a scalar or (B,)."""
    h = mpc.horizon
    stance = gait_table.reshape(-1, h, 4)
    rows = _cone_rows(mpc.friction_coef)
    G = rows * stance[..., None, None]
    fz = torch.as_tensor(fz_max, dtype=torch.float32, device=stance.device)
    fz = fz.reshape(-1, 1, 1, 1) if fz.ndim == 1 else fz
    zero = torch.zeros_like(stance)[..., None].expand(stance.shape + (5,))
    h_stance = torch.cat([zero, fz.expand(stance.shape + (1,))], dim=-1)
    h_vec = torch.where(stance[..., None] > 0.0, h_stance, torch.ones_like(h_stance))
    return G, h_vec, stance


def variable_mask(gait_table: torch.Tensor, mpc: MpcParams) -> torch.Tensor:
    """(..., 12h) 1.0 for stance-controlled force components, 0.0 for swing."""
    return torch.repeat_interleave(gait_table, 3, dim=-1)


def mask_cost(H: torch.Tensor, g: torch.Tensor, mv: torch.Tensor):
    """Pin masked variables at 0: their rows and columns of H (B,n,n)
    become identity with zero gradient, so the masked optimum is the
    reference's (swing f = 0)."""
    Hm = H * mv[:, :, None] * mv[:, None, :] + torch.diag_embed(1.0 - mv)
    return Hm, g * mv
