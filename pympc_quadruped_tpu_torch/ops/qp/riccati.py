"""O(horizon) sparse Riccati-ADMM solver (port of ``ops/qp/riccati.py``).

The OSQP-style operator splitting of the MPC QP whose x-update is the
equality-constrained LQR

    min  sum_k (x_k - r_k)^T Q (x_k - r_k) + u_k^T R u_k
         + (sigma/2)||u_k - u_k^prev||^2 + (rho/2)||C u_k - z_k + y_k/rho||^2
    s.t. x_{k+1} = Ad x_k + B_k u_k,   x_0 = x_t,

solved exactly by a backward Riccati recursion: the factorization
(:func:`lqr_factor`) once per solve, then ``iterations`` over-relaxed sweeps
(:func:`iterate`).  Swing legs are removed by masking their B columns and
cost-pinning the variable; ``C^T C`` of the per-leg pyramid is diagonal, so
the input cost is a (12,) diagonal.  See the JAX module for the derivation.

:func:`lqr_factor` + :func:`iterate` are the plain PyTorch version of the
CUDA kernel in :mod:`.riccati_cuda`; :func:`solve_batch` picks the kernel
for CUDA tensors and this version for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pympc_quadruped_tpu_torch.models.mpc import NUM_INPUT, NUM_STATE, MpcParams
from pympc_quadruped_tpu_torch.models.robots import aliengo

ROWS_PER_LEG = 5
ROWS_PER_STEP = 20


class RiccatiConfig(NamedTuple):
    """Tuning of the sparse path (natural problem units, no Ruiz scaling).

    Defaults are the cold tuning of the JAX package; :meth:`inloop` is the
    warm receding-horizon preset the controller uses.  The JAX config's
    ``tile`` (the Pallas lane tile) has no counterpart here.
    """
    iterations: int = 56
    rho: float = 2.0e-4
    sigma: float = 1.0e-6
    alpha: float = 1.8
    pin: float = 1.0           # quadratic pin on removed swing variables
    normalize: bool = False    # per-scenario rho ∝ (m_ref/m)^2

    @classmethod
    def inloop(cls) -> "RiccatiConfig":
        """Warm-started receding-horizon preset with per-scenario rho
        normalization (see the JAX ``RiccatiConfig.inloop``)."""
        return cls(iterations=40, rho=4.0e-4, normalize=True)


#: Trunk mass [kg] of the robot every rho grid was tuned on (Aliengo),
#: taken from this package's own ``aliengo()`` rather than repeated.
MASS_NORM_REF = float(aliengo(device="cpu").mass)


def rho_scale_from_Bd(Bd: torch.Tensor, mpc: MpcParams) -> torch.Tensor:
    """Per-scenario step-size normalization ``(m_ref / m)^2``, (B,).

    Read off the RAW ``Bd`` taken at ``dt_predict``: its linear-velocity
    rows are exactly ``dt/m * I3`` per stance leg, so the mean square of
    rows 9:12 is ``(dt/m)^2``."""
    s = torch.sum(torch.square(Bd[:, 9:12, :]), dim=(1, 2)) / 12.0
    ref = (mpc.dt_predict / MASS_NORM_REF) ** 2
    return s / ref


class RiccatiFactors(NamedTuple):
    """Iteration-invariant LQR factorization (batch-major)."""
    K: torch.Tensor       # (B,h,12,13) feedback gains
    Minv: torch.Tensor    # (B,h,12,12) inverses of Hu + B^T P B
    Bk: torch.Tensor      # (B,h,13,12) per-step (swing-masked) input maps


def _pyramid_rows(mu: torch.Tensor) -> torch.Tensor:
    """The (5,3) per-(step,leg) friction-pyramid block
    ``[1,0,mu], [-1,0,mu], [0,1,mu], [0,-1,mu], [0,0,1]``.

    Shared with :mod:`.admm_fast`; its JAX home is
    ``ops/qp/admm_fast.py::_pyramid_rows``."""
    mu = torch.as_tensor(mu)
    one, zero = torch.ones_like(mu), torch.zeros_like(mu)
    return torch.stack([
        torch.stack([one, zero, mu]),
        torch.stack([-one, zero, mu]),
        torch.stack([zero, one, mu]),
        torch.stack([zero, -one, mu]),
        torch.stack([zero, zero, one]),
    ])


def cone_block(device="cuda") -> torch.Tensor:
    """The (5,3) per-leg friction-pyramid rows in l <= C f <= u form at the
    reference's mu = 0.7 (ref ``linear_mpc/mpc.py:239-245``), on ``device``."""
    return _pyramid_rows(torch.tensor(0.7, dtype=torch.float32, device=device))


def _gauss_jordan_inv(M: torch.Tensor) -> torch.Tensor:
    """Pivot-free Gauss-Jordan inverse of small SPD blocks, batched over
    leading axes.

    Shared with :mod:`.admm_fast` (the Schur recursion's leaves); its JAX
    home is ``ops/qp/admm_fast.py::_gauss_jordan_inv``."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    A = torch.cat([M, eye], dim=-1)                            # (...,n,2n)
    for k in range(n):
        pivot_row = A[..., k, :] / A[..., k : k + 1, k]
        factors = A[..., :, k]
        A = A - factors[..., :, None] * pivot_row[..., None, :]
        A[..., k, :] = pivot_row
    return A[..., :, n:]


def step_gating(gait_table: torch.Tensor, horizon: int):
    """Per-step masks from the stance table: m_u (B,h,12) on stance force
    components, gate (B,h,20) on stance pyramid rows."""
    stance = gait_table.reshape(-1, horizon, 4)
    m_u = torch.repeat_interleave(stance, 3, dim=-1)
    gate = torch.repeat_interleave(stance, ROWS_PER_LEG, dim=-1)
    return m_u, gate


def step_bounds(gait_table: torch.Tensor, fz_max, horizon: int):
    """(B,h,20) lower/upper row bounds: stance rows ``0 <= . <= inf`` except
    the fz row's ``fz_max``; swing rows inactive (``0 <= z <= 1``)."""
    stance = gait_table.reshape(-1, horizon, 4)
    B = stance.shape[0]
    fz = torch.as_tensor(fz_max, dtype=torch.float32, device=stance.device)
    if fz.ndim == 1:
        fz = fz[:, None, None]
    inf = torch.full_like(stance, float("inf"))
    u_leg = torch.stack(
        [inf, inf, inf, inf, fz.expand(stance.shape)], dim=-1
    ).reshape(B, horizon, ROWS_PER_STEP)
    gate = torch.repeat_interleave(stance, ROWS_PER_LEG, dim=-1)
    u = torch.where(gate > 0.0, u_leg, torch.ones_like(u_leg))
    return torch.zeros_like(u), u


def input_cost_diag(m_u: torch.Tensor, mpc: MpcParams, cfg: RiccatiConfig,
                    rho_b: torch.Tensor | None = None):
    """(B,h,12) diagonal of Hu_k = 2R + sigma + rho C^T C (stance) or the pin
    (swing); C^T C per leg = diag(2, 2, 4 mu^2 + 1).  ``rho_b``: optional
    (B,) per-scenario step size, else the scalar ``cfg.rho``."""
    mu = mpc.friction_coef
    ctc_leg = torch.stack([torch.ones_like(mu) * 2.0, torch.ones_like(mu) * 2.0,
                           4.0 * mu * mu + 1.0])
    base = 2.0 * mpc.r_diag + cfg.sigma
    ctc = ctc_leg.repeat(4)
    rho = cfg.rho if rho_b is None else rho_b[:, None, None]
    return torch.where(m_u > 0.0, base + rho * ctc, base + cfg.pin)


def lqr_factor(Ad, Bd, hu, m_u, mpc: MpcParams) -> RiccatiFactors:
    """Backward Riccati matrix pass: P_h = 2Q; for k = h-1 .. 0

        M_k = Hu_k + B_k^T P_{k+1} B_k          (12x12 SPD)
        G_k = B_k^T P_{k+1} Ad                  (12x13)
        K_k = M_k^{-1} G_k
        P_k = 2Q + Ad^T P_{k+1} Ad - G_k^T K_k  (symmetrized)

    with B_k = Bd masked to stance columns.  Shapes: Ad (B,13,13), Bd
    (B,13,12), hu and m_u (B,h,12).
    """
    h = mpc.horizon
    q2 = torch.diag(2.0 * mpc.q_diag)                          # (13,13)
    AdT = Ad.transpose(-1, -2)
    P = q2.expand(Ad.shape).clone()
    Ks, Minvs, Bks = [None] * h, [None] * h, [None] * h
    for k in range(h - 1, -1, -1):
        Bk = Bd * m_u[:, k, None, :]                           # (B,13,12)
        PB = P @ Bk
        M = Bk.transpose(-1, -2) @ PB
        M = 0.5 * (M + M.transpose(-1, -2))
        M = M + torch.diag_embed(hu[:, k])
        Minv = _gauss_jordan_inv(M)
        G = PB.transpose(-1, -2) @ Ad                          # (B,12,13)
        K = Minv @ G
        P = AdT @ (P @ Ad) - G.transpose(-1, -2) @ K
        P = 0.5 * (P + P.transpose(-1, -2)) + q2
        Ks[k], Minvs[k], Bks[k] = K, Minv, Bk
    return RiccatiFactors(K=torch.stack(Ks, 1), Minv=torch.stack(Minvs, 1),
                          Bk=torch.stack(Bks, 1))


def _cone_matvec(pat, u):                                     # (B,h,12)->(B,h,20)
    B, h, _ = u.shape
    out = torch.einsum("rc,bhlc->bhlr", pat, u.reshape(B, h, 4, 3))
    return out.reshape(B, h, ROWS_PER_STEP)


def _cone_rmatvec(pat, w):                                    # (B,h,20)->(B,h,12)
    B, h, _ = w.shape
    out = torch.einsum("rc,bhlr->bhlc", pat, w.reshape(B, h, 4, ROWS_PER_LEG))
    return out.reshape(B, h, NUM_INPUT)


def _mv(M, v):                                                # (B,a,b),(B,b)->(B,a)
    return (M @ v[..., None])[..., 0]


def iterate(factors: RiccatiFactors, Ad, x_t, X_ref, gate, l, u_bnd,
            mpc: MpcParams, cfg: RiccatiConfig, init=None,
            rho_b: torch.Tensor | None = None):
    """Over-relaxed ADMM sweeps.  Returns (U (B,h,12), y (B,h,20)).

    ``init``: optional (u0, z0, y0) warm start.  ``rho_b``: optional (B,)
    per-scenario step size; must match the rho folded into ``hu`` by
    :func:`input_cost_diag`."""
    B, h = X_ref.shape[0], X_ref.shape[1]
    pat = _pyramid_rows(mpc.friction_coef).to(x_t)
    sigma, alpha = cfg.sigma, cfg.alpha
    rho = cfg.rho if rho_b is None else rho_b[:, None, None]
    q_x = -2.0 * mpc.q_diag * X_ref                           # (B,h,13)
    AdT = Ad.transpose(-1, -2)
    KT = factors.K.transpose(-1, -2)                          # (B,h,13,12)
    BT = factors.Bk.transpose(-1, -2)                         # (B,h,12,13)

    if init is None:
        u = x_t.new_zeros((B, h, NUM_INPUT))
        z = x_t.new_zeros((B, h, ROWS_PER_STEP))
        y = x_t.new_zeros((B, h, ROWS_PER_STEP))
    else:
        u, z, y = init
    for _ in range(cfg.iterations):
        q_u = _cone_rmatvec(pat, gate * (y - rho * z)) - sigma * u

        # Backward affine sweep k = h-1 .. 0.  At step k the state-cost row
        # folded into p is q_x[k-1] <-> x_k (p_0 is discarded).
        p = q_x[:, h - 1]
        d = [None] * h
        for k in range(h - 1, -1, -1):
            m_k = q_u[:, k] + _mv(BT[:, k], p)
            d[k] = _mv(factors.Minv[:, k], m_k)
            p = q_x[:, max(k - 1, 0)] + _mv(AdT, p) - _mv(KT[:, k], m_k)

        # Forward rollout.
        x = x_t
        u_t = [None] * h
        for k in range(h):
            u_t[k] = -_mv(factors.K[:, k], x) - d[k]
            x = _mv(Ad, x) + _mv(factors.Bk[:, k], u_t[k])
        u_tilde = torch.stack(u_t, 1)                          # (B,h,12)

        zt = gate * _cone_matvec(pat, u_tilde)
        u_new = alpha * u_tilde + (1.0 - alpha) * u
        zbar = alpha * zt + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(zbar + y / rho, l), u_bnd)
        y = y + rho * (zbar - z_new)
        u, z = u_new, z_new
    return u, y


def solve_batch(
    Ad: torch.Tensor,         # (B,13,13)
    Bd: torch.Tensor,         # (B,13,12)
    x_t: torch.Tensor,        # (B,13)
    X_ref: torch.Tensor,      # (B,h,13) or (B,13h)
    gait_table: torch.Tensor, # (B,4h)
    fz_max,
    mpc: MpcParams,
    cfg: RiccatiConfig = RiccatiConfig(),
    backend: str = "auto",
    warm=None,
    return_duals: bool = False,
):
    """Sparse-path batched MPC solve.  Returns (B,12h) U (+ (B,20h) duals).

    ``backend``: ``"auto"`` runs the CUDA kernel on CUDA tensors and the
    plain PyTorch version on CPU tensors; ``"torch"`` forces the plain
    version on any device (to compare with the kernel); ``"cuda"`` goes
    through the kernel's wrapper, which runs the plain version only on
    CPU tensors.  ``warm`` is an
    unscaled ``(U0 (B,12h), lam0 (B,20h))``, mapped straight onto (u, z, y).
    """
    B = x_t.shape[0]
    h = mpc.horizon
    X_ref = X_ref.reshape(B, h, NUM_STATE)
    m_u, gate = step_gating(gait_table, h)
    l, u_bnd = step_bounds(gait_table, fz_max, h)
    rho_b = None
    if cfg.normalize:
        rho_b = cfg.rho * rho_scale_from_Bd(Bd, mpc)          # (B,)
    hu = input_cost_diag(m_u, mpc, cfg, rho_b=rho_b)

    init = None
    if warm is not None:
        U0, lam0 = warm
        u0 = U0.to(x_t.dtype).reshape(B, h, NUM_INPUT)
        y0 = gate * lam0.to(x_t.dtype).reshape(B, h, ROWS_PER_STEP)
        pat = _pyramid_rows(mpc.friction_coef).to(x_t)
        z0 = torch.minimum(torch.maximum(gate * _cone_matvec(pat, u0), l), u_bnd)
        init = (u0, z0, y0)

    if backend == "auto":
        backend = "cuda" if x_t.is_cuda else "torch"
    if backend == "cuda":
        from pympc_quadruped_tpu_torch.ops.qp import riccati_cuda

        U, y = riccati_cuda.factor_iterate(
            Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd, mpc, cfg, init,
            rho_b=rho_b,
        )
    elif backend == "torch":
        factors = lqr_factor(Ad, Bd, hu, m_u, mpc)
        U, y = iterate(factors, Ad, x_t, X_ref, gate, l, u_bnd, mpc, cfg,
                       init, rho_b=rho_b)
    else:
        raise ValueError(f"unknown riccati backend {backend!r}")
    U = (U * m_u).reshape(B, h * NUM_INPUT)
    if return_duals:
        return U, y.reshape(B, h * ROWS_PER_STEP)
    return U
