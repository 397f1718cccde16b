"""The full 1 kHz control tick, batch-first (port of ``control/controller.py``).

Per tick: obs -> kinematics -> gait phase -> [every Nth tick: MPC solve ->
GRFs] -> swing-foot targets -> Jacobian-transpose torques.  Every argument
except ``mpc`` and ``tick`` carries a leading scenario axis.  The JAX
batch-level ``lax.cond`` solve gate is a host ``if`` on the shared Python
int tick, so the solve really runs only on solve ticks.  The tick is split
into pre-solve, solve and post-solve parts (:func:`step_gated`): the gate
reads a host bool, the tick math reads ``tick``, which may be a 0-d device
tensor, so a non-solve tick can be captured in a CUDA graph
(``env.srb_env.rollout``).

Solvers: ``"admm_fast"`` (the default; the condensed QP of
:func:`refmpc.build_qp` solved by :mod:`..ops.qp.admm_fast`, whose CUDA
kernels run on the card) and ``"riccati"`` (the sparse path, its own CUDA
kernel), both warm-started from the previous solve; and the parity
solvers, cold-started library-call paths: ``"admm"`` (the plain ADMM of
:mod:`..ops.qp.admm`, the on-device oracle), ``"ipm"`` (the f32
interior-point method of :mod:`..ops.qp.ipm`) and ``"ipm_parity"``
(float64 condensing, :func:`refmpc.build_qp_ff`, and the IPM's parity
configuration, solved in float64: the BASELINE 1e-3 GRF parity
configuration).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.control import ctrl_cuda, legctrl, refmpc, swing
from pympc_quadruped_tpu_torch.models.command import Command
from pympc_quadruped_tpu_torch.models.gaits import GaitParams
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import gaitsched, kin, srb
from pympc_quadruped_tpu_torch.ops.qp import admm, admm_fast, cones, ipm, riccati
from pympc_quadruped_tpu_torch.tree import tree_map
from pympc_quadruped_tpu_torch.utils import profiling, tape

DEFAULT_SOLVER = "admm_fast"
SOLVERS = ("admm_fast", "riccati", "admm", "ipm", "ipm_parity")


def check_solver(solver: str) -> None:
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")


@dataclass
class ControllerCarry:
    mpc: refmpc.MpcCarry
    swing: swing.SwingCarry


@dataclass
class ControllerOutput:
    torques: torch.Tensor        # (12,)
    contact_forces: torch.Tensor # (12,) world-frame GRFs currently held
    swing_states: torch.Tensor   # (4,)
    pos_targets: torch.Tensor    # (4,3) swing-foot targets rel. base, base frame
    vel_targets: torch.Tensor    # (4,3)
    kin: kin.KinState


def init_carry(horizon: int = 10, device="cuda") -> ControllerCarry:
    return ControllerCarry(mpc=refmpc.MpcCarry.init(horizon, device),
                           swing=swing.SwingCarry.init(device))


def _pre_solve(robot, mpc, gait, cmd, carry, obs, tick):
    """Everything before the solve decision (span ``ctrl.pre``); on float32
    CUDA operands one launch of the ``ctrl_pre`` kernel."""
    with profiling.span("ctrl.pre"):
        if ctrl_cuda.engages(robot, mpc, gait, cmd, carry.mpc, obs, tick):
            return ctrl_cuda.ctrl_pre(robot, mpc, gait, cmd, carry.mpc, obs, tick)
        ks = kin.compute_kin_state(robot, obs)
        swing_states = gaitsched.swing_state(gait, mpc, tick)
        table = gaitsched.gait_table(gait, mpc, tick)
        g_slot = (-mpc.gravity).expand(ks.rpy_base.shape[:-1] + (1,))
        x_t = torch.cat([ks.rpy_base, ks.pos_base, ks.ang_vel_base, ks.lin_vel_base,
                         g_slot], dim=-1).float()
        mpc_carry, vel_des_world = refmpc.integrate_desired(carry.mpc, ks, cmd, mpc)
    return ks, swing_states, table, x_t, mpc_carry, vel_des_world


def _solve_branch(robot, mpc, cmd, mpc_carry, ks, x_t, vel_des_world, table,
                  solver, ipm_cfg, admm_cfg, admm_fast_cfg, riccati_cfg):
    """Reference trajectory + batched QP solve; returns (carry', forces).

    ``riccati`` and ``admm_fast`` warm-start from the previous solve
    shifted by one MPC step (receding horizon: block k of this solve aligns
    with block k+1 of the last one; 12 variables and 20 cone rows per step,
    the trailing step repeats), and a failed solve resets that warm start
    to zeros (a cold restart next solve).  The parity solvers start cold
    and leave the warm start alone.  A scenario whose solution comes back
    non-finite keeps its previously held GRFs (the reference's last
    solution stays applied).

    Spans: ``solve.model`` (the reference trajectory and the QP's operands:
    the prediction model, or the condensed QP and its constraints) and
    ``solve.qp`` (the solve, with the warm start's shift and the carry's
    update)."""
    with profiling.span("solve.model"):
        ground_z = None
        if mpc.ground_adaptive_height:
            # Support-plane height from stance-foot leg odometry; flight steps
            # fall back to the all-feet mean.
            stance_now = table.reshape(-1, mpc.horizon, 4)[:, 0, :]
            feet_z = ks.pos_feet[:, :, 2]
            n_st = stance_now.sum(dim=-1)
            ground_z = torch.where(
                n_st > 0,
                (stance_now * feet_z).sum(dim=-1) / torch.clamp(n_st, min=1.0),
                feet_z.mean(dim=-1),
            )
        mpc_carry, X = refmpc.reference_trajectory(
            mpc_carry, x_t, vel_des_world, cmd, mpc, robot, table, ground_z=ground_z
        )

        yaw = x_t[:, 2]
        feet = ks.pos_base_feet
        if solver == "ipm_parity":
            # Float64 condensing + the IPM's parity configuration, in float64.
            H, H_lo, g, g_lo, mv = refmpc.build_qp_ff(robot, mpc, x_t, yaw, feet, X, table)
            G, h_vec, _ = cones.block_constraints(table, robot.fz_max, mpc)
        elif solver == "riccati":
            # Sparse O(h) path: no condensing, Ad/Bd feed the Riccati-ADMM solve.
            Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
            mv = cones.variable_mask(table, mpc)
        else:
            H, g, mv = refmpc.build_qp(robot, mpc, x_t, yaw, feet, X, table)
            if solver == "ipm":
                G, h_vec, _ = cones.block_constraints(table, robot.fz_max, mpc)
            elif solver == "admm":
                A, l, u = admm.admm_constraints(table, robot.fz_max, mpc)

    with profiling.span("solve.qp"):
        if solver == "ipm_parity":
            U = ipm.solve_batch(H, g, G, h_vec, ipm.PARITY_CONFIG, H_lo, g_lo)
        elif solver == "ipm":
            U = ipm.solve_batch(H, g, G, h_vec, ipm_cfg)
        elif solver == "admm":
            U = admm.solve_batch(H, g, A, l, u, admm_cfg)
        else:
            U_ws = torch.cat([mpc_carry.qp_primal[:, 12:], mpc_carry.qp_primal[:, -12:]], dim=-1)
            lam_ws = torch.cat([mpc_carry.qp_dual[:, 20:], mpc_carry.qp_dual[:, -20:]], dim=-1)
            # (U, lam) come back shaped as the warm start.
            if solver == "riccati":
                U, lam = tape.eager(
                    _warm_solve, (U_ws, lam_ws), riccati, Ad, Bd, x_t, X, table,
                    robot.fz_max, mpc, riccati_cfg, warm=(U_ws, lam_ws), return_duals=True,
                )
            else:
                U, lam = tape.eager(
                    _warm_solve, (U_ws, lam_ws), admm_fast, H, g, table, robot.fz_max, mpc,
                    admm_fast_cfg, warm=(U_ws, lam_ws), return_duals=True,
                )
            ok_ws = (torch.isfinite(U).all(dim=-1, keepdim=True)
                     & torch.isfinite(lam).all(dim=-1, keepdim=True))
            mpc_carry = dataclasses.replace(
                mpc_carry,
                qp_primal=torch.where(ok_ws, U * mv, torch.zeros_like(U)),
                qp_dual=torch.where(ok_ws, lam, torch.zeros_like(lam)),
            )
        ok = torch.isfinite(U).all(dim=-1, keepdim=True)
        forces = torch.where(ok, (U * mv)[:, :12], mpc_carry.contact_forces)
    return dataclasses.replace(mpc_carry, contact_forces=forces), forces


def _warm_solve(module, *args, **kwargs):
    """``module.solve_batch(*args, **kwargs)``, looked up at each call.  A
    loop on a card replays the rest of its solve tick from graphs and calls
    this eagerly (``utils/tape.py``), so the solver's kernels launch from the
    host on every solve tick."""
    return module.solve_batch(*args, **kwargs)


def _post_solve(robot, mpc, gait, cmd, carry, ks, swing_states, mpc_carry, forces):
    """Swing targets and leg torques from the held forces (span
    ``ctrl.post``); on float32 CUDA operands one launch of the
    ``ctrl_post`` kernel."""
    with profiling.span("ctrl.post"):
        if ctrl_cuda.engages(robot, mpc, gait, cmd, ks, carry.swing, swing_states, forces):
            swing_carry, pos_t, vel_t, torques = ctrl_cuda.ctrl_post(
                robot, mpc, gait, cmd, ks, carry.swing, swing_states, forces
            )
        else:
            swing_carry, pos_t, vel_t = swing.update_swing(
                robot, mpc, gait, cmd, ks, carry.swing, swing_states
            )
            torques = legctrl.leg_torques(robot, ks, forces, swing_states, pos_t, vel_t)
    out = ControllerOutput(
        torques=torques, contact_forces=forces, swing_states=swing_states,
        pos_targets=pos_t, vel_targets=vel_t, kin=ks,
    )
    return ControllerCarry(mpc=mpc_carry, swing=swing_carry), out


def is_solve_tick(mpc: MpcParams, tick: int) -> bool:
    """The 50 Hz solve gate, on the host int tick."""
    return int(tick) % mpc.iterations_between_mpc == 0


def step_gated(
    robot: RobotParams,
    mpc: MpcParams,
    gait: GaitParams,
    cmd: Command,
    carry: ControllerCarry,
    obs: kin.RobotObs,
    tick,
    solve: bool,
    solver: str = DEFAULT_SOLVER,
    ipm_cfg: ipm.IpmConfig = ipm.IpmConfig(),
    admm_cfg: admm.AdmmConfig = admm.AdmmConfig(),
    admm_fast_cfg: admm_fast.AdmmFastConfig = admm_fast.AdmmFastConfig.inloop(),
    riccati_cfg: riccati.RiccatiConfig = riccati.RiccatiConfig.inloop(),
):
    """One batched tick with the solve gate given as the host bool
    ``solve`` (:func:`is_solve_tick` of the host tick) and ``tick`` a Python
    int or a 0-d int32 tensor on the batch's device.  With ``solve=False``
    nothing here reads a device value on the host, so the tick can be
    captured in a CUDA graph.  Returns (carry', ControllerOutput)."""
    ks, swing_states, table, x_t, mpc_carry, vel_des_world = _pre_solve(
        robot, mpc, gait, cmd, carry, obs, tick
    )
    if solve:
        mpc_carry, forces = _solve_branch(
            robot, mpc, cmd, mpc_carry, ks, x_t, vel_des_world, table, solver,
            ipm_cfg, admm_cfg, admm_fast_cfg, riccati_cfg,
        )
    else:
        forces = mpc_carry.contact_forces
    return _post_solve(robot, mpc, gait, cmd, carry, ks, swing_states, mpc_carry, forces)


def step_batch(
    robot: RobotParams,
    mpc: MpcParams,
    gait: GaitParams,
    cmd: Command,
    carry: ControllerCarry,
    obs: kin.RobotObs,
    tick: int,
    solver: str = DEFAULT_SOLVER,
    ipm_cfg: ipm.IpmConfig = ipm.IpmConfig(),
    admm_cfg: admm.AdmmConfig = admm.AdmmConfig(),
    # In-loop presets: every solve after the first is warm-started from the
    # previous tick's shifted primal and duals.
    admm_fast_cfg: admm_fast.AdmmFastConfig = admm_fast.AdmmFastConfig.inloop(),
    riccati_cfg: riccati.RiccatiConfig = riccati.RiccatiConfig.inloop(),
):
    """Batched tick.  ``tick`` is the shared Python-int tick counter.
    Returns (carry', ControllerOutput) with leading scenario axes."""
    check_solver(solver)
    tick = int(tick)
    return step_gated(robot, mpc, gait, cmd, carry, obs, tick, is_solve_tick(mpc, tick),
                      solver, ipm_cfg, admm_cfg, admm_fast_cfg, riccati_cfg)


def step(
    robot: RobotParams,
    mpc: MpcParams,
    gait: GaitParams,
    cmd: Command,
    carry: ControllerCarry,
    obs: kin.RobotObs,
    tick: int,
    solver: str = DEFAULT_SOLVER,
    ipm_cfg: ipm.IpmConfig = ipm.IpmConfig(),
    admm_cfg: admm.AdmmConfig = admm.AdmmConfig(),
):
    """Single-scenario tick (batch size 1 under the hood)."""
    add = lambda t: t[None]
    carry_b, out_b = step_batch(
        tree_map(add, robot), mpc, tree_map(add, gait), tree_map(add, cmd),
        tree_map(add, carry), tree_map(add, obs), tick, solver=solver,
        ipm_cfg=ipm_cfg, admm_cfg=admm_cfg,
    )
    return tree_map(lambda t: t[0], carry_b), tree_map(lambda t: t[0], out_b)
