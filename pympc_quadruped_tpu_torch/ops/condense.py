"""QP condensing, batched: (Ad, Bd, x_t, X_ref) -> dense (H, g).

Port of ``ops/condense.py`` (``rollout_matrices``, ``qp_cost``,
``condense``) with a leading scenario axis in place of ``vmap``:

    X = Sx x_t + Su U,   Sx (13h,13),  Su (13h,12h) lower-block-Toeplitz
    H = 2 (Su^T Qbar Su + Rbar),  g = 2 Su^T Qbar (Sx x_t - X_ref)

The (13h x 12h)^T (13h x 12h) Gram product is a plain batched matrix
product, left to ``torch.matmul`` as the JAX package leaves it to XLA; the
package-wide TF32-off pin keeps it in full f32.  :func:`condense_ff` is the
parity path's condensing, in float64.  ``qp_cost_toeplitz`` is not ported
(ROADMAP Queue 1, item 13).
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.models.mpc import NUM_INPUT, NUM_STATE, MpcParams


def rollout_matrices(Ad: torch.Tensor, Bd: torch.Tensor, horizon: int):
    """(Sx, Su) for X = Sx x + Su U, batched over the leading axis.

    Ad (B,13,13), Bd (B,13,12) -> Sx (B,13h,13) whose row block i holds
    Ad^{i+1}, and Su (B,13h,12h) whose block (i, j) is Ad^{i-j} Bd for
    i >= j, else 0."""
    B = Ad.shape[0]
    eye = torch.eye(NUM_STATE, dtype=Ad.dtype, device=Ad.device).expand(B, -1, -1)
    pows = [eye]
    for _ in range(horizon):
        pows.append(pows[-1] @ Ad)                            # Ad^0 .. Ad^h
    Sx = torch.stack(pows[1:], dim=1).reshape(B, horizon * NUM_STATE, NUM_STATE)

    M = torch.stack(pows[:horizon], dim=1) @ Bd[:, None]      # (B,h,13,12): Ad^k Bd
    ii = torch.arange(horizon, device=Ad.device)[:, None]
    jj = torch.arange(horizon, device=Ad.device)[None, :]
    delta = torch.clamp(ii - jj, 0, horizon - 1)
    blocks = M[:, delta] * (ii >= jj)[None, :, :, None, None].to(Ad.dtype)  # (B,h,h,13,12)
    Su = blocks.permute(0, 1, 3, 2, 4).reshape(B, horizon * NUM_STATE, horizon * NUM_INPUT)
    return Sx, Su


def qp_cost(Sx: torch.Tensor, Su: torch.Tensor, x_t: torch.Tensor,
            X_ref: torch.Tensor, mpc: MpcParams):
    """Dense condensed cost H (B,12h,12h), g (B,12h); X_ref is (B,13h).

    Gram form H = 2 (W^T W + Rbar) with W = sqrt(Qbar) Su, summed as
    ``W^T W + (W^T W)^T``: the JAX module explains why (a direct
    Su^T Qbar Su leaves f32 asymmetry that can make H indefinite)."""
    h = mpc.horizon
    q_bar = mpc.q_diag.repeat(h)                               # (13h,)
    r_bar = mpc.r_diag.repeat(h)                               # (12h,)
    sqrt_q = torch.sqrt(q_bar)
    W = Su * sqrt_q[:, None]                                   # (B,13h,12h)
    WtW = W.transpose(-1, -2) @ W
    H = WtW + WtW.transpose(-1, -2) + 2.0 * torch.diag(r_bar)
    resid = (Sx @ x_t[..., None])[..., 0] - X_ref
    g = 2.0 * (W.transpose(-1, -2) @ (sqrt_q * resid)[..., None])[..., 0]
    return H, g


def condense(Ad, Bd, x_t, X_ref, mpc: MpcParams):
    """Full condensing, batched: X_ref (B,h,13) or (B,13h)."""
    Sx, Su = rollout_matrices(Ad, Bd, mpc.horizon)
    return qp_cost(Sx, Su, x_t, X_ref.reshape(x_t.shape[0], -1), mpc)


def condense_ff(Ad, Bd, x_t, X_ref, mpc: MpcParams):
    """Condensing in float64 for the reference-parity path, batched.

    Plain f32 condensing rounds H by ~1e-7 relative, and that rounding
    lands in the reduced Hessian's weak subspace (lambda_min ~ 2R = 4e-5)
    and moves the QP optimum by ~1e-1 N.  Here the f32 ``Ad``/``Bd``/
    ``x_t``/``X_ref`` and cost weights are condensed in float64 (the JAX
    package does it in float-float, a TPU having no float64) as
    ``H = Su^T Qbar Su + (Su^T Qbar Su)^T + 2 Rbar``.

    Returns the same four f32 words as the JAX function, (H_hi, H_lo,
    g_hi, g_lo), with hi the f32 rounding of the f64 value and lo the f32
    rounding of the remainder; feed the lo words to the parity IPM
    (``ipm.solve_batch(..., H_lo, g_lo)``)."""
    h = mpc.horizon
    B = x_t.shape[0]
    Sx, Su = rollout_matrices(Ad.double(), Bd.double(), h)
    q_bar = mpc.q_diag.double().repeat(h)                      # (13h,)
    r_bar = mpc.r_diag.double().repeat(h)                      # (12h,)
    Ht = Su.transpose(-1, -2) @ (q_bar[:, None] * Su)
    H = Ht + Ht.transpose(-1, -2) + 2.0 * torch.diag(r_bar)
    resid = (Sx @ x_t.double()[..., None])[..., 0] - X_ref.reshape(B, -1).double()
    g = 2.0 * (Su.transpose(-1, -2) @ (q_bar * resid)[..., None])[..., 0]
    H_hi, g_hi = H.float(), g.float()
    return H_hi, (H - H_hi.double()).float(), g_hi, (g - g_hi.double()).float()
