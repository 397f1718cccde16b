"""Batched MPC engine facade (port of ``engine.py``).

``solve_scenarios`` is the batched solve: a scenario batch of SRB states,
footholds, references and gait tables in, GRFs out.  Only the sparse
Riccati route is ported (state-space build -> exact ZOH -> Riccati-ADMM,
the hand-written CUDA kernel on a GPU); the other solvers raise
``NotImplementedError`` naming the ROADMAP item they wait for.
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.control.controller import check_solver
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import srb
from pympc_quadruped_tpu_torch.ops.qp import riccati
from pympc_quadruped_tpu_torch.tree import tile


def solve_scenarios(
    robot: RobotParams,
    mpc: MpcParams,
    x_t: torch.Tensor,            # (B,13)
    yaw: torch.Tensor,            # (B,)
    pos_base_feet: torch.Tensor,  # (B,4,3)
    X_ref: torch.Tensor,          # (B,h,13) or (B,13h)
    gait_table: torch.Tensor,     # (B,4h)
    solver: str = "admm",
    riccati_cfg: riccati.RiccatiConfig = riccati.RiccatiConfig(),
    return_full_horizon: bool = False,
    return_diagnostics: bool = False,
    warm=None,
    return_duals: bool = False,
):
    """Batched MPC solve.  ``robot`` may be unbatched (shared) or carry a
    leading batch axis.  Returns (B,12) first-step GRFs, or (B,12h) with
    ``return_full_horizon``; with ``return_duals`` also the (B,20h) cone
    duals to carry into the next ``warm`` = ``(U_prev, lam_prev)``."""
    # The engine's "admm" is the controller's "admm_fast"; "admm_ref" its "admm".
    check_solver({"admm": "admm_fast", "admm_ref": "admm"}.get(solver, solver))
    if return_diagnostics:
        raise NotImplementedError(
            "return_diagnostics needs build_qp/qp_residuals (ROADMAP Queue 1, item 8)"
        )
    if return_duals and not return_full_horizon:
        # The warm start consumes the full-horizon primal.
        raise ValueError("return_duals requires return_full_horizon=True")
    B = x_t.shape[0]
    if robot.mass.ndim == 0:
        robot = tile(robot, B)

    Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, pos_base_feet), mpc.dt_predict)
    res = riccati.solve_batch(
        Ad, Bd, x_t, X_ref.reshape(B, -1), gait_table, robot.fz_max, mpc,
        riccati_cfg, warm=warm, return_duals=return_duals,
    )
    U, lam = res if return_duals else (res, None)
    out = U if return_full_horizon else U[:, :12]
    return (out, lam) if return_duals else out
