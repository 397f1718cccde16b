"""Batched Mehrotra predictor-corrector interior-point QP solver (port of
``ops/qp/ipm.py``): the parity path and the independent cross-check of the
ADMM solvers.

Solves  min 1/2 x^T H x + g^T x  s.t.  G x <= h  with the per-block cone
rows of :mod:`.cones`, for a leading scenario axis:

- a fixed iteration count, a Python loop with no host read, so every
  scenario runs the same instruction stream;
- the cones enter only through per-block einsums and a block-diagonal
  normal-matrix update, so an iteration costs two batched (n x n) Cholesky
  solves (one factorization) plus small products;
- swing-leg forces are pinned by cost masking, keeping a strict interior;
- slack/multiplier floors and a cap on D = diag(lam/s) keep the iterations
  after convergence finite in float32;
- with ``refine_iters > 0`` (the parity configuration) every one of the
  ``iterations + refine_iters`` iterations runs in float64 on
  ``(H + H_lo, g + g_lo)``, the low words of float64 condensing
  (``condense.condense_ff``).  The JAX package runs the first
  ``iterations`` in float32 and then ``refine_iters`` float32 Newton steps
  on a float-float dual residual, because a TPU has no float64.  The
  reference QP is near-degenerate (reduced-Hessian lambda_min ~ 2R =
  4e-5): at h=16 the float32 iterations end, on some scenarios, with a
  wrong active set that 12 refinement steps do not repair, and which
  scenarios depends on the rounding of the solves, so the answer moved
  with the device and the batch size (up to 7.6e-2 of (1 + |U|) between
  an H100 and the CPU).  In float64 the solve reaches the float64 oracle
  within 9e-5 over chip_smoke.py phase 12a's 4096 scenarios and a change
  of rounding moves it by < 1e-7 (tools/parity_reference_h16.py,
  tools/parity_batch_probe.py).

Every per-scenario scalar of the JAX per-scenario program (the step
lengths, mu, sigma, the Jacobi scale and the finite-step guard) is a
(B,1) reduction over the last axis here, so one bad scenario never stalls
another.  Newton systems use the slack elimination

    (H + G^T diag(lam/s) G) dx = -r_d - G^T((lam*r_p - r_c)/s)
    ds = -r_p - G dx
    dlam = (-r_c - lam*ds)/s
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pympc_quadruped_tpu_torch.ops.qp import cones
from pympc_quadruped_tpu_torch.ops.qp.admm import cho_factor, cho_solve


class IpmConfig(NamedTuple):
    iterations: int = 18
    refine_iters: int = 0       # extra iterations; > 0 runs the whole solve in float64
    tau: float = 0.99           # fraction-to-boundary
    jitter: float = 1.0e-6      # relative Cholesky regularization
    s_floor: float = 1.0e-6
    lam_floor: float = 1.0e-7
    d_max: float = 1.0e6        # cap on lam/s barrier scaling
    s_init: float = 1.0
    lam_init: float = 1.0


def _pos_step(z: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Largest alpha in (0,1] with z + alpha dz >= 0, per scenario: (B,1)."""
    neg = dz < 0.0
    ratio = torch.where(neg, -z / torch.where(neg, dz, -torch.ones_like(dz)),
                        torch.full_like(dz, float("inf")))
    return torch.minimum(torch.ones_like(z[:, :1]), ratio.amin(dim=-1, keepdim=True))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1, keepdim=True)


def solve_batch(H, g, G, h_vec, cfg: IpmConfig = IpmConfig(), H_lo=None, g_lo=None):
    """Batched solve: H (B,n,n), g (B,n), G (B,h,4,6,3), h_vec (B,h,4,6);
    optional H_lo (B,n,n) and g_lo (B,n), the low words of the data, read
    only when ``cfg.refine_iters > 0``.  Returns x* (B,n) float32."""
    B, n = g.shape
    shape = h_vec.shape
    h_flat = h_vec.reshape(B, -1)
    m = h_flat.shape[-1]
    jitter = cfg.jitter
    if cfg.refine_iters > 0:
        # The parity solve: every iteration in float64 on the full-precision
        # data.  The regularization keeps its size relative to the
        # factorization's rounding: a float32-sized jitter would damp the
        # Newton step along the QP's weak directions and stall the solve
        # short of the optimum.
        H = H.double() if H_lo is None else H.double() + H_lo.double()
        g = g.double() if g_lo is None else g.double() + g_lo.double()
        G, h_flat = G.double(), h_flat.double()
        jitter = cfg.jitter * torch.finfo(torch.float64).eps / torch.finfo(torch.float32).eps
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    diag_scale = H.diagonal(dim1=-2, dim2=-1).mean(dim=-1)[:, None, None]
    zero = torch.zeros((), dtype=H.dtype, device=H.device)

    def newton_step(x, s, lam, r_d):
        """One predictor-corrector step given the dual residual r_d."""
        r_p = cones.block_matvec(G, x).reshape(B, -1) + s - h_flat
        mu = _dot(s, lam) / m

        d = torch.clamp(lam / s, max=cfg.d_max).reshape(shape)
        M = H + cones.block_normal_matrix(G, d) + (jitter * diag_scale) * eye
        # Jacobi scaling: near convergence the barrier term spreads diag(M)
        # over ~11 orders of magnitude, beyond a float32 Cholesky; a unit
        # diagonal restores the problem's structural conditioning.
        dsi = torch.rsqrt(torch.clamp(M.diagonal(dim1=-2, dim2=-1), min=1e-30))
        L = cho_factor(M * dsi[:, :, None] * dsi[:, None, :] + jitter * eye)

        def kkt_solve(r_c):
            rhs = -r_d - cones.block_rmatvec(G, ((lam * r_p - r_c) / s).reshape(shape))
            dx = dsi * cho_solve(L, (dsi * rhs)[..., None])[..., 0]
            ds = -r_p - cones.block_matvec(G, dx).reshape(B, -1)
            dlam = (-r_c - lam * ds) / s
            return dx, ds, dlam

        dx_a, ds_a, dlam_a = kkt_solve(s * lam)
        alpha_a = torch.minimum(_pos_step(s, ds_a), _pos_step(lam, dlam_a))
        mu_aff = _dot(s + alpha_a * ds_a, lam + alpha_a * dlam_a) / m
        sigma = (torch.clamp(mu_aff, min=1e-12) / torch.clamp(mu, min=1e-9)) ** 3

        dx, ds, dlam = kkt_solve(s * lam + ds_a * dlam_a - sigma * mu)
        alpha = cfg.tau * torch.minimum(_pos_step(s, ds), _pos_step(lam, dlam))
        alpha = torch.clamp(alpha, max=1.0)

        # Finite-step guard: near convergence the f32 Cholesky sits on a
        # knife-edge (scaled pivots ~ sqrt(eps_f32)); a negative pivot NaNs
        # the factor (cho_factor) and the step.  The scenario then rejects
        # the step (alpha = 0) and keeps its last good iterate.  Regression
        # fixture: tests/data/qp_nan_knife_edge.npz.
        ok = (torch.isfinite(dx).all(dim=-1, keepdim=True)
              & torch.isfinite(ds).all(dim=-1, keepdim=True)
              & torch.isfinite(dlam).all(dim=-1, keepdim=True))
        dx, ds, dlam = (torch.where(ok, v, zero) for v in (dx, ds, dlam))
        alpha = torch.where(ok, alpha, zero)

        x = x + alpha * dx
        s = torch.clamp(s + alpha * ds, min=cfg.s_floor)
        lam = torch.clamp(lam + alpha * dlam, min=cfg.lam_floor)
        return x, s, lam

    x = torch.zeros_like(g)
    s = torch.clamp(h_flat, min=cfg.s_init)
    lam = torch.full_like(h_flat, cfg.lam_init)
    for _ in range(cfg.iterations + cfg.refine_iters):
        r_d = (H @ x[..., None])[..., 0] + g + cones.block_rmatvec(G, lam.reshape(shape))
        x, s, lam = newton_step(x, s, lam, r_d)
    return x.float()


# Preset for reference-parity paths: 18 + 12 iterations, all in float64.
PARITY_CONFIG = IpmConfig(iterations=18, refine_iters=12)
