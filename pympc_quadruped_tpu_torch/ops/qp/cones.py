"""Friction-cone structure of the condensed MPC QP (port of
``ops/qp/cones.py``), batched over a leading scenario axis.

Every (step, leg) block owns a 3-vector of forces constrained by
``|fx| <= mu fz, |fy| <= mu fz, 0 <= fz <= fz_max`` on stance legs.  Swing
legs are pinned instead of constrained: their cost becomes an identity
quadratic with zero gradient (optimum exactly 0) and their cone rows the
trivially inactive ``0 <= 1``, so shapes stay static whatever legs swing.
The per-block products :func:`block_matvec`, :func:`block_rmatvec` and
:func:`block_normal_matrix` serve the IPM (:mod:`.ipm`) and the plain ADMM
(:mod:`.admm`), whose constraint rows keep the same per-block layout.
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


def block_matvec(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """G @ x by blocks: G (B,h,4,r,3), x (B,12h) -> (B,h,4,r)."""
    h = G.shape[-4]
    xb = x.reshape(x.shape[:-1] + (h, 4, 3))
    return torch.einsum("...hlrc,...hlc->...hlr", G, xb)


def block_rmatvec(G: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """G^T @ y by blocks: y (B,h,4,r) -> (B,12h)."""
    out = torch.einsum("...hlrc,...hlr->...hlc", G, y)
    return out.reshape(out.shape[:-3] + (-1,))


def block_normal_matrix(G: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """G^T diag(d) G as a dense (B,12h,12h) block-diagonal matrix, for row
    weights d (B,h,4,r).  The 3x3 blocks sit on the diagonal of a
    (B, 4h, 4h, 3, 3) block array, which is permuted to (B, 4h, 3, 4h, 3)
    before the reshape, so each block keeps its orientation."""
    blocks = torch.einsum("...hlrc,...hlr,...hlrd->...hlcd", G, d, G)   # (B,h,4,3,3)
    lead = blocks.shape[:-4]
    n_blk = blocks.shape[-4] * 4
    flat = blocks.reshape(lead + (n_blk, 1, 3, 3))
    on_diag = torch.eye(n_blk, dtype=torch.bool, device=G.device)[..., None, None]
    out = torch.where(on_diag, flat, torch.zeros((), dtype=G.dtype, device=G.device))
    nd = len(lead)
    out = out.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    return out.reshape(lead + (3 * n_blk, 3 * n_blk))
