"""Batched MPC engine facade (port of ``engine.py``).

``solve_scenarios`` is the batched solve: a scenario batch of SRB states,
footholds, references and gait tables in, GRFs out.  Routes: ``"admm"``
(the default) and its alias ``"admm_fast"`` condense the QP
(``refmpc.build_qp``) and solve it with :mod:`.ops.qp.admm_fast`, whose
CUDA kernels run on a GPU; ``"riccati"`` goes state-space -> exact ZOH ->
Riccati-ADMM without condensing; ``"admm_ref"`` solves the condensed QP
with the plain ADMM of :mod:`.ops.qp.admm` (the on-device oracle) and
``"ipm"`` with the interior-point method of :mod:`.ops.qp.ipm` (the
independent cross-check), both cold-started library-call paths.  Only the
fast path and the Riccati path take a warm start or return duals.
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.control import refmpc
from pympc_quadruped_tpu_torch.control.controller import check_solver
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import srb
from pympc_quadruped_tpu_torch.ops.qp import admm, admm_fast, cones, ipm, riccati
from pympc_quadruped_tpu_torch.tree import tile
from pympc_quadruped_tpu_torch.utils import observability


def solve_scenarios(
    robot: RobotParams,
    mpc: MpcParams,
    x_t: torch.Tensor,            # (B,13)
    yaw: torch.Tensor,            # (B,)
    pos_base_feet: torch.Tensor,  # (B,4,3)
    X_ref: torch.Tensor,          # (B,h,13) or (B,13h)
    gait_table: torch.Tensor,     # (B,4h)
    solver: str = "admm",
    ipm_cfg: ipm.IpmConfig = ipm.IpmConfig(),
    admm_cfg: admm.AdmmConfig = admm.AdmmConfig(),
    admm_fast_cfg: admm_fast.AdmmFastConfig = admm_fast.AdmmFastConfig(),
    riccati_cfg: riccati.RiccatiConfig = riccati.RiccatiConfig(),
    return_full_horizon: bool = False,
    return_diagnostics: bool = False,
    warm=None,
    return_duals: bool = False,
):
    """Batched MPC solve.  ``robot`` may be unbatched (shared) or carry a
    leading batch axis.  Returns (B,12) first-step GRFs, or (B,12h) with
    ``return_full_horizon``; with ``return_diagnostics`` also the
    per-scenario QP health dict of :func:`observability.qp_residuals`; with
    ``return_duals`` last the (B,20h) cone duals, to carry into the next
    ``warm`` = ``(U_prev, lam_prev)``: ``(U[, diag][, lam])``."""
    # The engine's "admm" is the controller's "admm_fast"; "admm_ref" its "admm".
    # The controller's "ipm_parity" pipeline (build_qp_ff) is no engine route.
    if solver == "ipm_parity":
        raise ValueError(f"unknown solver {solver!r}")
    check_solver({"admm": "admm_fast", "admm_ref": "admm"}.get(solver, solver))
    if (warm is not None or return_duals) and solver not in ("admm", "admm_fast", "riccati"):
        raise ValueError("warm/return_duals require the fast ADMM or riccati path")
    if return_duals and not return_full_horizon:
        # The warm start consumes the full-horizon primal.
        raise ValueError("return_duals requires return_full_horizon=True")
    B = x_t.shape[0]
    if robot.mass.ndim == 0:
        robot = tile(robot, B)
    X_ref = X_ref.reshape(B, -1)

    H = g = None
    if solver == "riccati":
        Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, pos_base_feet), mpc.dt_predict)
        mv = cones.variable_mask(gait_table, mpc)
        res = riccati.solve_batch(
            Ad, Bd, x_t, X_ref, gait_table, robot.fz_max, mpc,
            riccati_cfg, warm=warm, return_duals=return_duals,
        )
    else:
        H, g, mv = refmpc.build_qp(robot, mpc, x_t, yaw, pos_base_feet, X_ref, gait_table)
        if solver == "ipm":
            G, h_vec, _ = cones.block_constraints(gait_table, robot.fz_max, mpc)
            res = ipm.solve_batch(H, g, G, h_vec, ipm_cfg)
        elif solver == "admm_ref":
            A, l, u = admm.admm_constraints(gait_table, robot.fz_max, mpc)
            res = admm.solve_batch(H, g, A, l, u, admm_cfg)
        else:
            res = admm_fast.solve_batch(
                H, g, gait_table, robot.fz_max, mpc, admm_fast_cfg,
                warm=warm, return_duals=return_duals,
            )
    U, lam = res if return_duals else (res, None)
    U = U * mv
    results = [U if return_full_horizon else U[:, :12]]
    if return_diagnostics:
        if H is None:
            H, g, _ = refmpc.build_qp(robot, mpc, x_t, yaw, pos_base_feet, X_ref, gait_table)
        results.append(observability.qp_residuals(H, g, gait_table, robot.fz_max, U, mpc))
    if return_duals:
        results.append(lam)
    return results[0] if len(results) == 1 else tuple(results)
