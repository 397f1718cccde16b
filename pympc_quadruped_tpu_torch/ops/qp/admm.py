"""Batched OSQP-style ADMM with an explicit inverse: the plain on-device
oracle (port of ``ops/qp/admm.py``).

Solves the reference's condensed problem in its native double-sided form
(ref ``linear_mpc/mpc.py:237-260``)

    min 1/2 x^T H x + g^T x   s.t.  l <= A x <= u

with A the block-diagonal friction pyramid (5 rows per (step, leg) block:
fx +- mu fz >= 0, fy +- mu fz >= 0, 0 <= fz <= gait * fz_max).  Swing-leg
variables are pinned by cost masking, as in the IPM.  Over-relaxed ADMM
with a per-row rho:

    K = H + sigma I + A^T diag(rho) A          (SPD; inverted once)
    xt   = Kinv (sigma x - g + A^T (rho z - y))
    zt   = A xt
    x+   = alpha xt + (1-alpha) x
    zbar = alpha zt + (1-alpha) z
    z+   = clip(zbar + y/rho, l, u)
    y+   = y + rho (zbar - z+)

Kinv comes from a batched Cholesky factorization (:func:`cho_factor`, a
library call), then a fixed number of sweeps, a Python loop of fixed
length with no host read.  Every argument carries a leading scenario axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.ops.qp import cones
from pympc_quadruped_tpu_torch.ops.qp.riccati import _pyramid_rows

ADMM_ROWS_PER_BLOCK = 5


class AdmmConfig(NamedTuple):
    """The JAX package's tuning on trot-family condensed QPs: the tiny
    input weight R = 1e-5 makes kappa(H) ~ 1e5, which favours a small rho
    and strong over-relaxation."""
    iterations: int = 250
    rho: float = 0.003         # penalty on inequality rows
    rho_eq: float = 3.0        # boosted penalty where l == u (tight bounds)
    sigma: float = 1.0e-6
    alpha: float = 1.8         # over-relaxation


def cho_factor(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of M (...,n,n), all NaN for a
    scenario whose factorization failed, as ``jnp.linalg.cholesky`` gives
    it.  ``cholesky_ex`` reads no error flag on the host."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def cho_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M^-1 rhs for rhs (...,n,k), from :func:`cho_factor`'s L of M."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def pyramid_rows(mu) -> torch.Tensor:
    """(5,3) reference cone rows, l <= rows @ f <= u (ref mpc.py:239-245)."""
    return _pyramid_rows(mu)


def admm_constraints(gait_table: torch.Tensor, fz_max, mpc: MpcParams):
    """Per-block A (B,h,4,5,3), l (B,h,4,5), u (B,h,4,5) from the (B,4h)
    stance table; ``fz_max`` is a scalar or (B,).

    Swing blocks get zero rows with l = 0, u = 1 (trivially satisfied by
    z = 0); their variables are pinned by the cost mask instead."""
    h = mpc.horizon
    stance = gait_table.reshape(-1, h, 4)
    A = pyramid_rows(mpc.friction_coef) * stance[..., None, None]
    fz = torch.as_tensor(fz_max, dtype=torch.float32, device=stance.device)
    fz = fz.reshape(-1, 1, 1, 1) if fz.ndim == 1 else fz
    inf = torch.full(stance.shape + (4,), float("inf"), device=stance.device)
    u_stance = torch.cat([inf, fz.expand(stance.shape + (1,))], dim=-1)
    u = torch.where(stance[..., None] > 0.0, u_stance, torch.ones_like(u_stance))
    return A, torch.zeros_like(u), u


def solve_batch(H, g, A, l, u, cfg: AdmmConfig = AdmmConfig()) -> torch.Tensor:
    """Batched solve: H (B,n,n), g (B,n), A (B,h,4,5,3), l and u (B,h,4,5).
    Returns x (B,n) after ``cfg.iterations`` sweeps from zero."""
    B, n = g.shape
    l_flat, u_flat = l.reshape(B, -1), u.reshape(B, -1)
    # Per-row rho: boost near-equality rows (l == u), OSQP-style.
    rho = torch.where((u_flat - l_flat) < 1e-6,
                      torch.full_like(l_flat, cfg.rho_eq), torch.full_like(l_flat, cfg.rho))
    rho_blocks = rho.reshape(l.shape)

    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    K = H + cfg.sigma * eye + cones.block_normal_matrix(A, rho_blocks)
    Kinv = cho_solve(cho_factor(K), eye.expand(B, n, n))

    amat = lambda v: cones.block_matvec(A, v).reshape(B, -1)
    atmat = lambda w: cones.block_rmatvec(A, w.reshape(l.shape))
    x = torch.zeros_like(g)
    z = torch.zeros_like(l_flat)
    y = torch.zeros_like(l_flat)
    for _ in range(cfg.iterations):
        rhs = cfg.sigma * x - g + atmat(rho * z - y)
        xt = (Kinv @ rhs[..., None])[..., 0]
        zt = amat(xt)
        x_new = cfg.alpha * xt + (1.0 - cfg.alpha) * x
        zbar = cfg.alpha * zt + (1.0 - cfg.alpha) * z
        z_new = torch.minimum(torch.maximum(zbar + y / rho, l_flat), u_flat)
        y = y + rho * (zbar - z_new)
        x, z = x_new, z_new
    return x
