"""QP condensing, batched: (Ad, Bd, x_t, X_ref) -> dense (H, g).

Port of ``ops/condense.py`` (``rollout_matrices``, ``qp_cost``,
``qp_cost_toeplitz``, ``condense``) with a leading scenario axis in place
of ``vmap``:

    X = Sx x_t + Su U,   Sx (13h,13),  Su (13h,12h) lower-block-Toeplitz
    H = 2 (Su^T Qbar Su + Rbar),  g = 2 Su^T Qbar (Sx x_t - X_ref)

The (13h x 12h)^T (13h x 12h) Gram product is a plain batched matrix
product, left to ``torch.matmul`` as the JAX package leaves it to XLA; the
package-wide TF32-off pin keeps it in full f32.  :func:`condense_ff` is the
parity path's condensing, in float64.  :func:`qp_cost_toeplitz` is the same
algebra in its FLOP-minimal block-Toeplitz form; as in the JAX package, no
solver path uses it (``build_qp`` keeps :func:`qp_cost`).
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


def qp_cost_toeplitz(Ad: torch.Tensor, Bd: torch.Tensor, x_t: torch.Tensor,
                     X_ref: torch.Tensor, mpc: MpcParams):
    """Condensed (H, g) through the block-Toeplitz suffix-sum identity,
    batched: Ad (B,13,13), Bd (B,13,12), x_t (B,13), X_ref (B,13h) or
    (B,h,13).

    Su's block (i, j) is M_{i-j} = Ad^{i-j} Bd, so with W_k = sqrt(Q) M_k

        (Su^T Qbar Su)(j, j') = S_delta[h-1-j'],  delta = j' - j >= 0,
        S_delta[e] = sum_{c=0..e} W_{c+delta}^T W_c   (a cumsum over c):

    only the h(h+1)/2 distinct 12x12 products are formed, ~2.4h times fewer
    operations than the Gram product of :func:`qp_cost`.  sqrt(Q) sits on
    both sides, so the delta = 0 blocks are Gram products; their lower
    triangles are copies of their upper ones, and every block below the
    diagonal is the transpose of its mirror above it, so H is exactly
    symmetric.  The sums run in another order than :func:`qp_cost`'s, so
    H agrees with it to f32 rounding, not bit for bit."""
    h = mpc.horizon
    B = Ad.shape[0]
    eye = torch.eye(NUM_STATE, dtype=Ad.dtype, device=Ad.device).expand(B, -1, -1)
    pows = [eye]
    for _ in range(h):
        pows.append(pows[-1] @ Ad)                            # Ad^0 .. Ad^h
    Sx = torch.stack(pows[1:], dim=1).reshape(B, h * NUM_STATE, NUM_STATE)
    M = torch.stack(pows[:h], dim=1) @ Bd[:, None]            # (B,h,13,12)
    W = torch.sqrt(mpc.q_diag)[:, None] * M                   # (B,h,13,12)

    # S[:, delta, e] = cumsum_c W[c+delta]^T W[c]; zero past e = h-1-delta.
    S = torch.zeros((B, h, h, NUM_INPUT, NUM_INPUT), dtype=Ad.dtype, device=Ad.device)
    for delta in range(h):
        prods = W[:, delta:].transpose(-1, -2) @ W[:, :h - delta]   # (B,h-delta,12,12)
        if delta == 0:
            prods = torch.triu(prods) + torch.triu(prods, 1).transpose(-1, -2)
        S[:, delta, :h - delta] = torch.cumsum(prods, dim=1)

    ii = torch.arange(h, device=Ad.device)[:, None]
    jj = torch.arange(h, device=Ad.device)[None, :]
    upper = S[:, torch.clamp(jj - ii, 0, h - 1), h - 1 - jj]              # (B,h,h,12,12)
    lower = S[:, torch.clamp(ii - jj, 0, h - 1), h - 1 - ii].transpose(-1, -2)
    Hb = torch.where((jj >= ii)[:, :, None, None], upper, lower)
    H = (2.0 * Hb.permute(0, 1, 3, 2, 4).reshape(B, h * NUM_INPUT, h * NUM_INPUT)
         + 2.0 * torch.diag(mpc.r_diag.repeat(h)))

    # g = 2 Su^T Qbar (Sx x - X_ref): block j is sum_{i>=j} M_{i-j}^T QY_i.
    y = (Sx @ x_t[..., None])[..., 0] - X_ref.reshape(B, -1)
    QY = (mpc.q_diag.repeat(h) * y).reshape(B, h, NUM_STATE)
    g = torch.cat([(M[:, :h - j].transpose(-1, -2) @ QY[:, j:, :, None])[..., 0].sum(dim=1)
                   for j in range(h)], dim=-1)
    return H, 2.0 * g


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
