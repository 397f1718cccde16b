"""The condensed MPC QP's optimum in float64, and what a solution costs.

The problem (ref ``linear_mpc/mpc.py:262-290``): minimise 1/2 U^T H U +
g^T U with each stance foot's force in the friction pyramid |fx| <= mu fz,
|fy| <= mu fz, 0 <= fz <= fz_max, and swing feet's forces pinned at 0 (the
masked H carries an identity row for them with zero gradient).  Solved by
a predictor-corrector interior-point method to KKT residuals ~1e-10,
batched: each row leaves the loop on its own certificate.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _pyramid(mu, dtype, device):
    """(6,3) rows of G f <= h for one stance foot."""
    return torch.tensor([[-1, 0, -mu], [1, 0, -mu], [0, -1, -mu], [0, 1, -mu],
                         [0, 0, -1], [0, 0, 1]], dtype=dtype, device=device)


def constraints(table, mu, fz_max):
    """Dense (G (R,6nb,3nb), h (R,6nb)) over the stance blocks; swing
    blocks' rows are 0 <= 1.  ``fz_max`` (R,)."""
    R_, nb = table.shape
    stance = table.to(F64)
    rows = _pyramid(mu, F64, table.device)
    G = torch.zeros(R_, nb, 6, nb, 3, dtype=F64, device=table.device)
    k = torch.arange(nb, device=table.device)
    G[:, k, :, k, :] = (rows[None, None] * stance[:, :, None, None]).transpose(0, 1)
    h_st = torch.zeros(R_, nb, 6, dtype=F64, device=table.device)
    h_st[..., 5] = fz_max.to(F64)[:, None]
    h = torch.where(stance[..., None] > 0, h_st, torch.ones_like(h_st))
    return G.reshape(R_, 6 * nb, 3 * nb), h.reshape(R_, 6 * nb)


def optimum(H, g, table, mu, fz_max, tol=1e-10, max_iter=80):
    """(U* (R,n), certificate (R,)): the float64 optimum of the masked QP
    and its largest KKT residual.  A row whose normal matrix stops being
    positive definite in float64 near the end (the barrier weights of the
    active rows span 1e20 and more against H's weakest direction, 2e-5)
    stops at its last iterate; its certificate says how close that is."""
    H, g = H.to(F64), g.to(F64)
    G, h = constraints(table, mu, fz_max)
    GT = G.transpose(-1, -2)
    R_, n = g.shape
    m = h.shape[1]
    x = torch.zeros(R_, n, dtype=F64, device=g.device)
    s = torch.clamp(h, min=1.0)
    lam = torch.ones(R_, m, dtype=F64, device=g.device)
    active = torch.ones(R_, dtype=torch.bool, device=g.device)
    ridge = 1e-13 * torch.eye(n, dtype=F64, device=g.device)

    def residuals(x, s, lam):
        r_d = _mv(H, x) + g + _mv(GT, lam)
        r_p = _mv(G, x) + s - h
        kkt = torch.stack([r_d.abs().amax(-1), r_p.abs().amax(-1), (s * lam).abs().amax(-1)], -1)
        return r_d, r_p, kkt.amax(-1)

    def max_step(z, dz):
        return torch.where(dz < 0, -z / dz, torch.full_like(z, float("inf"))).amin(-1).clamp(max=1.0)

    for _ in range(max_iter):
        r_d, r_p, kkt = residuals(x, s, lam)
        active &= ~(kkt < tol)
        gap = (s * lam).sum(-1) / m
        L, info = torch.linalg.cholesky_ex(H + GT @ ((lam / s)[..., None] * G) + ridge)
        active &= info == 0
        if not bool(active.any()):
            break

        def direction(r_c):
            rhs = -r_d - _mv(GT, (lam * r_p - r_c) / s)
            dx = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            ds = -r_p - _mv(G, dx)
            return dx, ds, (-r_c - lam * ds) / s

        dx, ds, dl = direction(s * lam)
        a = torch.minimum(max_step(s, ds), max_step(lam, dl))[:, None]
        mu_aff = ((s + a * ds) * (lam + a * dl)).sum(-1) / m
        sigma = (mu_aff / torch.clamp(gap, min=1e-16)) ** 3
        dx, ds, dl = direction(s * lam + ds * dl - (sigma * gap)[:, None])
        a = (0.99 * torch.minimum(max_step(s, ds), max_step(lam, dl))).clamp(max=1.0)[:, None]
        step = active[:, None]
        x = torch.where(step, x + a * dx, x)
        s = torch.where(step, torch.clamp(s + a * ds, min=1e-300), s)
        lam = torch.where(step, torch.clamp(lam + a * dl, min=1e-300), lam)
    _, _, kkt = residuals(x, s, lam)
    return x, torch.where(torch.isfinite(kkt), kkt, torch.full_like(kkt, float("inf")))


def cost(H, g, U):
    V = U.to(F64)
    return 0.5 * (V[:, None, :] @ H.to(F64) @ V[:, :, None])[:, 0, 0] + (g.to(F64) * V).sum(-1)


def cone_violation(U, table, mu, fz_max):
    """(R,) the worst stance-row violation of the pyramid [N]."""
    G, h = constraints(table, mu, fz_max)
    viol = _mv(G, U.to(F64)) - h
    return viol.clamp(min=0.0).amax(-1)
