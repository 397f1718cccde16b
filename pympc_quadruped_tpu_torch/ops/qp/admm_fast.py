"""Batched ADMM for the condensed MPC QP (port of ``ops/qp/admm_fast.py``).

The controller's default solver.  OSQP-style over-relaxed operator splitting
with a per-row rho on the Ruiz-equilibrated problem (see the JAX module for
the derivation and tuning history):

1. :func:`ruiz_scaling` scales the variables by D from H's row inf-norms;
   the cone rows are normalized by E (:func:`pattern_row_norms`);
2. K = Hs + sigma I + A^T rho A, with A = diag(E stance) P0 diag(D) and P0
   the shared friction-pyramid pattern (:func:`cone_pattern`), so A^T rho A
   is block-diagonal with 3x3 blocks;
3. :func:`spd_inverse` inverts K by a symmetrized 2x2 block Schur recursion
   down to Gauss-Jordan leaves, then Newton-Schulz refinement;
4. ``iterations`` fixed sweeps (:func:`iterate_jnp`), then unscaling.

This module holds the plain PyTorch versions of the four hand-written CUDA
kernels in :mod:`.admm_cuda`: ``spd_inverse`` (kernel ``invert_spd``),
``iterate_jnp`` (``iterate``), the two together (``iterate_fused``) and
:func:`solve_full` (``solve_full``: setup, inversion, sweeps, unscaling).
:func:`solve_batch` keeps the JAX backend names: ``"jnp"`` is the plain
version; ``"pallas"``, ``"pallas_split"``, ``"pallas_fused"`` and
``"pallas_full"`` go through the CUDA kernels of the same JAX names, which
run their plain versions on CPU tensors.  ``"auto"`` is ``"pallas_split"``
on CUDA tensors and ``"jnp"`` on CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.ops.qp.riccati import _gauss_jordan_inv, _pyramid_rows

ROWS_PER_BLOCK = 5  # fx+-mu fz >= 0 (2), fy+-mu fz >= 0 (2), 0 <= fz <= fzmax

BACKENDS = ("jnp", "pallas", "pallas_split", "pallas_fused", "pallas_full")


class AdmmFastConfig(NamedTuple):
    """Solver tuning; defaults are the JAX package's cold-start tuning and
    :meth:`inloop` its warm receding-horizon preset.  The JAX config's
    ``tile`` (the Pallas grid tile) has no counterpart: the CUDA kernels
    run one thread block per scenario."""
    iterations: int = 56
    rho: float = 0.0005        # penalty on inequality rows (scaled problem)
    rho_eq: float = 1.0        # boosted penalty where l == u
    sigma: float = 1.0e-6
    alpha: float = 1.8         # over-relaxation
    ruiz_iters: int = 1
    newton_schulz_iters: int = 1

    @classmethod
    def inloop(cls) -> "AdmmFastConfig":
        """Warm-started receding-horizon preset: 40 iterations at rho 1e-3
        (see the JAX ``AdmmFastConfig.inloop`` for the measurements)."""
        return cls(iterations=40, rho=0.001)


# ---------------------------------------------------------------------------
# Shared friction-pyramid pattern and row data
# ---------------------------------------------------------------------------

def cone_pattern(mu, horizon: int) -> torch.Tensor:
    """The fixed (5*4h, 12h) block-diagonal pyramid pattern P0, on ``mu``'s
    device.  Row layout per (step, leg) block (ref linear_mpc/mpc.py:239-245):
    ``[1,0,mu], [-1,0,mu], [0,1,mu], [0,-1,mu], [0,0,1]``."""
    rows = _pyramid_rows(mu)
    n_blk = 4 * horizon
    eye = torch.eye(n_blk, dtype=rows.dtype, device=rows.device)
    full = torch.einsum("rc,ij->irjc", rows, eye)
    return full.reshape(n_blk * ROWS_PER_BLOCK, n_blk * 3)


def row_bounds(gait_table: torch.Tensor, fz_max, horizon: int):
    """Per-row (srow, l, u), each (B,20h): the stance mask repeated per cone
    row; bounds with the swing rows trivially satisfied by z = 0."""
    stance_blk = gait_table.reshape(-1, 4 * horizon)
    srow = torch.repeat_interleave(stance_blk, ROWS_PER_BLOCK, dim=-1)
    fz = torch.as_tensor(fz_max, dtype=torch.float32, device=stance_blk.device)
    if fz.ndim == 1:  # per-scenario fz_max (randomization sweep)
        fz = fz[:, None]
    inf = torch.full_like(stance_blk, float("inf"))
    u_blk = torch.stack([inf, inf, inf, inf, fz.expand(stance_blk.shape)], dim=-1)
    u = torch.where(srow > 0.0, u_blk.reshape(srow.shape), torch.ones_like(srow))
    return srow, torch.zeros_like(u), u


def ruiz_scaling(H: torch.Tensor, srow: torch.Tensor, P0_abs_colmax, iters: int):
    """Modified Ruiz equilibration, batched: per-variable D (B,n) from the
    row inf-norms of H, ``iters`` passes, each delta = 1/sqrt of the norm
    clipped to [1e-4, 1e4] (two correctly rounded operations, as the CUDA
    kernel computes it).  ``srow`` and ``P0_abs_colmax`` are unused, as in
    the JAX signature.  Returns (Hs = D H D, d)."""
    d = torch.ones(H.shape[:-1], dtype=H.dtype, device=H.device)
    Hs = H
    for _ in range(iters):
        col = Hs.abs().amax(dim=-1)
        delta = torch.clamp(1.0 / torch.sqrt(torch.clamp(col, min=1e-8)), 1e-4, 1e4)
        Hs = Hs * delta[:, :, None] * delta[:, None, :]
        d = d * delta
    return Hs, d


def pattern_row_norms(mu, d: torch.Tensor, horizon: int) -> torch.Tensor:
    """Inf-norms of the rows of P0 @ diag(d): (B, 20h)."""
    B = d.shape[0]
    db = d.reshape(B, 4 * horizon, 3)
    dx, dy, dz = db[..., 0], db[..., 1], db[..., 2]
    mdz = mu * dz
    rows = torch.stack([torch.maximum(dx, mdz), torch.maximum(dx, mdz),
                        torch.maximum(dy, mdz), torch.maximum(dy, mdz), dz], dim=-1)
    return rows.reshape(B, 4 * horizon * ROWS_PER_BLOCK)


# ---------------------------------------------------------------------------
# SPD inverse (plain version of the CUDA kernel admm_cuda.invert_spd)
# ---------------------------------------------------------------------------

def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def _schur_inverse(M: torch.Tensor) -> torch.Tensor:
    """Recursive 2x2 block Schur inverse of a symmetric (B,n,n), split at
    n // 2 down to Gauss-Jordan leaves of size <= 16:

        K = [[A, B], [B^T, C]],  W = A^-1 B,  S = sym(C - B^T W)
        K^-1 = [[sym(A^-1 + W S^-1 W^T), -W S^-1], [(-W S^-1)^T, S^-1]]
    """
    n = M.shape[-1]
    if n <= 16:
        return _gauss_jordan_inv(M)
    m = n // 2
    A, Bm, C = M[..., :m, :m], M[..., :m, m:], M[..., m:, m:]
    Ai = _schur_inverse(A)
    W = Ai @ Bm
    S = _sym(C - Bm.transpose(-1, -2) @ W)
    Si = _schur_inverse(S)
    WSi = W @ Si
    TL = _sym(Ai + WSi @ W.transpose(-1, -2))
    top = torch.cat([TL, -WSi], dim=-1)
    bot = torch.cat([-WSi.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_inverse(K: torch.Tensor, newton_schulz_iters: int = 1) -> torch.Tensor:
    """Inverse of batched SPD (B,n,n) matrices: the Schur recursion on
    sym(K), then ``newton_schulz_iters`` steps X <- sym(X (2I - K X)).

    The input and every Schur complement are symmetrized: the recursion
    reads only the upper block triangle, so a 1-ulp asymmetry would grow by
    ~kappa^2 through the levels and can make the Newton-Schulz step diverge
    (the JAX module has the measurement)."""
    X = _schur_inverse(_sym(K))
    eye2 = 2.0 * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    for _ in range(newton_schulz_iters):
        X = _sym(X @ (eye2 - K @ X))
    return X


# ---------------------------------------------------------------------------
# Setup: the scaled problem
# ---------------------------------------------------------------------------

class AdmmOperands(NamedTuple):
    """Operands with the KKT matrix already inverted (``setup(invert=True)``),
    for :func:`iterate_jnp` and ``admm_cuda.iterate``."""
    Kinv: torch.Tensor  # (B,n,n): inverse of (scaled H + sigma I + A^T rho A)
    q: torch.Tensor     # (B,n) scaled gradient
    d: torch.Tensor     # (B,n) variable scaling (x = d * x_scaled)
    es: torch.Tensor    # (B,m) row scaling * stance gate
    rho: torch.Tensor   # (B,m) per-row penalty
    l: torch.Tensor     # (B,m) scaled lower bounds
    u: torch.Tensor     # (B,m) scaled upper bounds


class AdmmKktOperands(NamedTuple):
    """Operands with the un-inverted scaled KKT matrix (``setup(invert=False)``),
    for ``admm_cuda.invert_iterate`` and ``admm_cuda.iterate_fused``."""
    K: torch.Tensor     # (B,n,n): scaled H + sigma I + A^T rho A (NOT inverted)
    q: torch.Tensor
    d: torch.Tensor
    es: torch.Tensor
    rho: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor


def setup_rows(H, g, srow, l, u, mu, cfg: AdmmFastConfig, invert: bool = True):
    """:func:`setup` from the per-row ``(srow, l, u)`` of :func:`row_bounds`:
    Ruiz scaling, cone-row scaling E, per-row rho, and
    K = Hs + A^T rho A + sigma I (inverted with ``invert``)."""
    B, n = g.shape
    h = n // 12
    Hs, d = ruiz_scaling(H, srow, None, cfg.ruiz_iters)
    g_s = g * d

    # Row scaling E: normalize the scaled pyramid rows to unit inf-norm.
    e = 1.0 / torch.clamp(pattern_row_norms(mu, d, h), min=1e-8)
    es = e * srow                                              # gated rows
    l_s = l * e                                                # zeros stay zero
    u_s = u * e                                                # inf stays inf
    rho = torch.where((u_s - l_s) < 1e-6, torch.full_like(u_s, cfg.rho_eq),
                      torch.full_like(u_s, cfg.rho))

    # A^T rho A is block-diagonal, one 3x3 block per (step, leg):
    #   blk = d_blk (pat^T diag(rho_blk es_blk^2) pat) d_blk^T,
    # summed over the 5 rows in order, as the CUDA kernel sums it.
    pat = _pyramid_rows(mu).to(H)
    w = (rho * es * es).reshape(B, 4 * h, ROWS_PER_BLOCK)
    core = torch.zeros((B, 4 * h, 3, 3), dtype=H.dtype, device=H.device)
    for r in range(ROWS_PER_BLOCK):
        core = core + pat[r, :, None] * w[..., r, None, None] * pat[r, None, :]
    db = d.reshape(B, 4 * h, 3)
    core = core * db[..., :, None] * db[..., None, :]
    K = Hs.clone()
    K.view(B, 4 * h, 3, 4 * h, 3).diagonal(dim1=1, dim2=3).add_(core.permute(0, 2, 3, 1))
    K.diagonal(dim1=-2, dim2=-1).add_(cfg.sigma)
    if invert:
        Kinv = spd_inverse(K, cfg.newton_schulz_iters)
        return AdmmOperands(Kinv=Kinv, q=g_s, d=d, es=es, rho=rho, l=l_s, u=u_s)
    return AdmmKktOperands(K=K, q=g_s, d=d, es=es, rho=rho, l=l_s, u=u_s)


def setup(H, g, gait_table, fz_max, mpc: MpcParams, cfg: AdmmFastConfig,
          invert: bool = True):
    """Scale and assemble (and, with ``invert``, invert) the batched masked
    condensed QP.  ``invert=False`` returns :class:`AdmmKktOperands`, the
    input of the kernels that invert K themselves."""
    srow, l, u = row_bounds(gait_table, fz_max, mpc.horizon)
    return setup_rows(H, g, srow, l, u, mpc.friction_coef, cfg, invert)


def warm_init(ops, P0: torch.Tensor, warm):
    """Map an unscaled warm start ``(U0 (B,n), lam0 (B,m))`` into the
    scaled coordinates of ``ops``: ``x0 = U0 / d``,
    ``z0 = clip(es * (P0 U0), l, u)``, ``y0 = lam0 / es`` (zero on gated
    swing rows).  All-zero ``warm`` is exactly the cold start."""
    U0, lam0 = (a.to(ops.q.dtype) for a in warm)
    gated = ops.es > 0.0
    safe_es = torch.where(gated, ops.es, torch.ones_like(ops.es))
    x0 = U0 / ops.d
    z0 = torch.minimum(torch.maximum(ops.es * (U0 @ P0.T), ops.l), ops.u)
    y0 = torch.where(gated, lam0 / safe_es, torch.zeros_like(lam0))
    return x0, z0, y0


# ---------------------------------------------------------------------------
# Iteration (plain version of the CUDA kernel admm_cuda.iterate)
# ---------------------------------------------------------------------------

def iterate_jnp(ops: AdmmOperands, P0: torch.Tensor, cfg: AdmmFastConfig,
                init=None):
    """Scaled ADMM iterations, batch-major.  Returns scaled (x, y).

    ``init`` is an optional scaled warm start (x0, z0, y0); zeros (the cold
    start) otherwise.  The name is the JAX package's."""
    if not isinstance(ops, AdmmOperands):
        raise TypeError(
            "iterate_jnp needs AdmmOperands (setup(invert=True)); got "
            f"{type(ops).__name__}: route it to admm_cuda.iterate_fused"
        )
    B, n = ops.q.shape
    m = ops.l.shape[-1]
    sigma, alpha = cfg.sigma, cfg.alpha
    if init is None:
        x, z, y = (ops.q.new_zeros((B, k)) for k in (n, m, m))
    else:
        x, z, y = init
    for _ in range(cfg.iterations):
        rhs = sigma * x - ops.q + ((ops.es * (ops.rho * z - y)) @ P0) * ops.d
        xt = (ops.Kinv @ rhs[..., None])[..., 0]
        zt = ops.es * ((xt * ops.d) @ P0.T)
        x_new = alpha * xt + (1.0 - alpha) * x
        zbar = alpha * zt + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(zbar + y / ops.rho, ops.l), ops.u)
        y = y + ops.rho * (zbar - z_new)
        x, z = x_new, z_new
    return x, y


def solve_full(H, g, srow, l, u, P0: torch.Tensor, cfg: AdmmFastConfig, warm=None):
    """Plain version of the one-kernel solve ``admm_cuda.solve_full``:
    setup from the raw masked (H, g) and row data, inversion, sweeps and
    unscaling.  ``mu`` is read off P0.  Returns unscaled ``(U, lam)``."""
    ops = setup_rows(H, g, srow, l, u, P0[0, 2], cfg)
    init = None if warm is None else warm_init(ops, P0, warm)
    x, y = iterate_jnp(ops, P0, cfg, init)
    return x * ops.d, ops.es * y


def solve_batch(H, g, gait_table, fz_max, mpc: MpcParams,
                cfg: AdmmFastConfig = AdmmFastConfig(),
                backend: str = "auto",
                warm=None,
                return_duals: bool = False):
    """Batched fast-ADMM solve of the masked condensed QP.

    H (B,12h,12h) and g (B,12h) have the swing variables cost-pinned
    (``cones.mask_cost``).  Returns (B,12h) U in problem units (the caller
    applies the swing mask for exact zeros), and with ``return_duals`` also
    the unscaled (B,20h) row duals to carry into the next ``warm``, an
    unscaled ``(U0, lam0)``.  ``backend`` is one of :data:`BACKENDS` or
    ``"auto"`` (module docstring)."""
    if backend == "auto":
        backend = "pallas_split" if g.is_cuda else "jnp"
    if backend not in BACKENDS:
        raise ValueError(f"unknown admm_fast backend {backend!r}")
    P0 = cone_pattern(mpc.friction_coef, mpc.horizon).to(g)
    if backend == "jnp":
        ops = setup(H, g, gait_table, fz_max, mpc, cfg)
        init = None if warm is None else warm_init(ops, P0, warm)
        x, y = iterate_jnp(ops, P0, cfg, init)
    else:
        from pympc_quadruped_tpu_torch.ops.qp import admm_cuda

        if backend == "pallas_full":
            srow, l, u = row_bounds(gait_table, fz_max, mpc.horizon)
            U, lam = admm_cuda.solve_full(H, g, srow, l, u, P0, cfg, warm=warm)
            return (U, lam) if return_duals else U
        ops = setup(H, g, gait_table, fz_max, mpc, cfg, invert=backend == "pallas")
        init = None if warm is None else warm_init(ops, P0, warm)
        x, y = {"pallas": admm_cuda.iterate,
                "pallas_split": admm_cuda.invert_iterate,
                "pallas_fused": admm_cuda.iterate_fused}[backend](ops, P0, cfg, init)
    U = x * ops.d
    return (U, ops.es * y) if return_duals else U
