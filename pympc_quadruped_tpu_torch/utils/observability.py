"""Solver-health telemetry and metric logging (port of
``utils/observability.py``).

- :func:`qp_residuals`: the on-device health of a batch of returned GRF
  solutions, cheap enough to ride along with every engine solve;
- :func:`kkt_residuals_f64` and :func:`kkt_gate`: the float64 KKT
  certificate of solutions with their duals against the raw problem data,
  computed in torch on the caller's device (so a run on the card certifies
  its solutions there), and its pass/fail gate;
- :class:`MetricsLogger`: per-step metric dicts kept as device tensors and
  drained to the host in one transfer.
"""
from __future__ import annotations

import numpy as np
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


def kkt_residuals_f64(H, g, gait_table, fz_max, U, lam, mpc: MpcParams) -> dict[str, torch.Tensor]:
    """Float64 KKT certificate of a batch of solutions with duals, per
    scenario, against the raw problem data ``(H, g, bounds)``: independent
    of every solver-internal transformation (Ruiz scaling, K assembly), so
    a common-mode setup bug that fools a comparison of two solvers still
    fails here.

    OSQP form ``l <= P0 U <= u``: stationarity ``H U + g + P0^T lam = 0``,
    lam < 0 active at the lower bound and lam > 0 at the upper.  Returns
    (B,) tensors on U's device: ``stat_rel``, the inf-norm of the
    stationarity residual over the gradient terms' magnitude;
    ``primal_N``, the worst bound violation of the gated rows [N];
    ``comp_N``, the worst complementarity product over (1 + fz_max), in
    Newtons of mismatched force; ``finite``, U and lam all finite.  ``U``
    must be swing-masked and ``lam`` as ``solve_batch(...,
    return_duals=True)`` returns it."""
    f64 = lambda t: torch.as_tensor(t).to(device=U.device, dtype=torch.float64)
    h = mpc.horizon
    H, g, U, lam = f64(H), f64(g), f64(U), f64(lam)
    P0 = f64(admm_fast.cone_pattern(mpc.friction_coef, h))
    table = torch.as_tensor(gait_table, device=U.device)
    srow, l, u = map(f64, admm_fast.row_bounds(table, fz_max, h))
    z = U @ P0.T                                             # (B,m)
    HU = (H @ U[..., None])[..., 0]                          # (B,n)
    stat = HU + g + lam @ P0
    gscale = 1.0 + torch.maximum(g.abs().amax(dim=-1), HU.abs().amax(dim=-1))
    stat_rel = stat.abs().amax(dim=-1) / gscale

    ninf = torch.full_like(z, -float("inf"))
    gated_lo = torch.where(srow > 0, l - z, ninf)
    gated_up = torch.where((srow > 0) & torch.isfinite(u), z - u, ninf)
    primal = torch.clamp(torch.maximum(gated_lo.amax(dim=-1), gated_up.amax(dim=-1)), min=0.0)

    comp_lo = (torch.clamp(lam, max=0.0) * (z - l)).abs()
    comp_up = torch.clamp(lam, min=0.0) * torch.where(torch.isfinite(u), u - z,
                                                      torch.ones_like(u))
    comp = torch.maximum(comp_lo, comp_up.abs()).amax(dim=-1) / (1.0 + f64(fz_max).max())

    finite = torch.isfinite(U).all(dim=-1) & torch.isfinite(lam).all(dim=-1)
    return {"stat_rel": stat_rel, "primal_N": primal, "comp_N": comp, "finite": finite}


def kkt_gate(res: dict[str, torch.Tensor], fz_max) -> tuple[bool, dict[str, float]]:
    """Pass/fail gate over :func:`kkt_residuals_f64` at the 99th
    percentile, with the JAX package's thresholds (set from its on-chip
    measurements of the shipping cold configuration, where a 5% setup-bug
    injection moves stat_rel ~7x above the worst clean level): stationarity
    below 1e-2 of the gradient scale, primal violation below 1e-3 fz_max
    (the BASELINE feasibility bar), complementarity below 1e-2 N."""
    fz = float(torch.as_tensor(fz_max).max())
    p99 = lambda t: float(torch.quantile(t.double(), 0.99))
    stat, primal, comp = p99(res["stat_rel"]), p99(res["primal_N"]), p99(res["comp_N"])
    finite = bool(res["finite"].all())
    ok = finite and stat < 1e-2 and primal < 1e-3 * fz and comp < 1e-2
    return ok, {
        "kkt_stat_rel_p99": round(stat, 6),
        "kkt_primal_N_p99": round(primal, 6),
        "kkt_comp_N_p99": round(comp, 6),
        "kkt_finite": finite,
    }


class MetricsLogger:
    """Accumulate per-step metric dicts of device tensors (or numbers) and
    drain them to the host in one transfer:

        log = MetricsLogger()
        for step in ...:
            log.append({"mean_vel_err": m1, "survival": m2})   # no sync
        table = log.drain()    # {key: np.ndarray (steps, ...)}
    """

    def __init__(self):
        self._buf: list[dict] = []

    def append(self, metrics: dict) -> None:
        self._buf.append(dict(metrics))

    def __len__(self) -> int:
        return len(self._buf)

    def drain(self) -> dict[str, np.ndarray]:
        """Every key's values stacked over the appended steps; each keeps
        its dtype.  The stacks go to the host as one float64 buffer (exact
        for float32, integer and bool metrics)."""
        if not self._buf:
            return {}
        dev = next((v.device for row in self._buf for v in row.values()
                    if isinstance(v, torch.Tensor)), torch.device("cpu"))
        stacks = {k: torch.stack([torch.as_tensor(row[k], device=dev) for row in self._buf])
                  for k in self._buf[0]}
        flat = torch.cat([v.reshape(-1).double() for v in stacks.values()]).cpu().numpy()
        out, start = {}, 0
        for k, v in stacks.items():
            out[k] = flat[start:start + v.numel()].reshape(tuple(v.shape)).astype(
                str(v.dtype).removeprefix("torch."))
            start += v.numel()
        self._buf.clear()
        return out
