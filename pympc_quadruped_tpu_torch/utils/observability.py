"""Solver-health telemetry (port of ``utils/observability.qp_residuals``).

:func:`qp_residuals` is the on-device health of a batch of returned GRF
solutions, cheap enough to ride along with every engine solve.  The JAX
module's host-side f64 KKT certificate (``kkt_residuals_f64``/``kkt_gate``)
and its metric logger are not ported: the tests run the JAX certificate on
the port's numpy outputs.
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.ops.qp import admm_fast


def qp_residuals(
    H: torch.Tensor,           # (B,n,n) masked condensed Hessian
    g: torch.Tensor,           # (B,n)
    gait_table: torch.Tensor,  # (B,4h)
    fz_max,
    U: torch.Tensor,           # (B,n) returned solution
    mpc: MpcParams,
) -> dict[str, torch.Tensor]:
    """Per-scenario QP health: ``qp_primal_violation``, the worst violation
    of the friction-pyramid rows; ``qp_grad_norm``, |H U + g| on stance
    variables (at an exact solution the constraint-force reaction, so a
    magnitude scale whose explosion or NaN flags a failed solve); and
    ``qp_finite``, 1.0 where U is finite."""
    h = mpc.horizon
    P0 = admm_fast.cone_pattern(mpc.friction_coef, h)
    srow, l, u = admm_fast.row_bounds(gait_table, fz_max, h)
    z = (U @ P0.T) * srow
    upper = torch.where(torch.isfinite(u), z - u, torch.full_like(z, -float("inf")))
    primal = torch.maximum((l - z).amax(dim=-1), upper.amax(dim=-1))
    mv = torch.repeat_interleave(gait_table, 3, dim=-1)
    grad = (H @ U[..., None])[..., 0] + g
    return {
        "qp_primal_violation": torch.clamp(primal, min=0.0),
        "qp_grad_norm": torch.linalg.vector_norm(grad * mv, dim=-1),
        "qp_finite": torch.isfinite(U).all(dim=-1).to(torch.float32),
    }
