"""Scenario sweep runners on one card (port of ``parallel/sweep.py``).

Build a scenario batch, then run either :func:`solve_sweep_step` (one
batched condense + solve, the benchmark unit) or :func:`rollout_sweep` /
:func:`gait_sweep` (closed-loop SRB rollouts reduced to sweep metrics).
The JAX package shards the batch over a device mesh; here the batch lives
on one device, and a ``mesh`` raises ``NotImplementedError`` until the
distributed part is ported (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch import engine, tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.models.command import Command
from pympc_quadruped_tpu_torch.models.gaits import GaitParams, Gaits
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams


def _single_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet: the distributed sweep waits for "
            "ROADMAP Queue 1, item 12")


def make_scenario_batch(robot: RobotParams, gait: GaitParams, cmd: Command, batch: int):
    """Tile single-scenario params into a batch (randomize by editing leaves)."""
    return tree.tile(robot, batch), tree.tile(gait, batch), tree.tile(cmd, batch)


#: Per-gait forward-velocity commands for the mixed-gait sweep (m/s).
GAIT_SWEEP_VX = {
    "trotting10": 1.2,
    "trotting16": 1.0,
    "pacing10": 0.8,
    "pacing16": 0.8,
    "bounding8": 0.6,
    "jumping16": 0.4,
    "standing": 0.0,
}


def mixed_gait_batch(names: list[str], batch: int, device="cuda"):
    """A (B,)-batched ``(GaitParams, Command, gait_id)`` cycling through
    ``names``, with each scenario's command from :data:`GAIT_SWEEP_VX`.
    The gaits share leaf shapes, so mixing them is stacking leaves."""
    ids = torch.arange(batch, dtype=torch.int32, device=device) % len(names)
    gaits = [Gaits.by_name(n, device) for n in names]
    stacked = tree.tree_map(lambda *xs: torch.stack(xs), *gaits)
    gait_b = tree.tree_map(lambda x: x[ids.long()], stacked)
    vx = torch.tensor([GAIT_SWEEP_VX[n] for n in names], dtype=torch.float32,
                      device=device)[ids.long()]
    zero = torch.zeros_like(vx)
    cmd_b = Command(vel_base_des=torch.stack([vx, zero, zero], dim=-1), yaw_turn_rate=zero)
    return gait_b, cmd_b, ids


def _alive(env_state, metrics, num_ticks: int) -> torch.Tensor:
    """(B,) survival over the last quarter: height in (0.1, 1.0) and
    upright above 0.6 throughout."""
    upright_tail = metrics["upright"][-num_ticks // 4:]
    return ((env_state.pos[:, 2] > 0.1) & (env_state.pos[:, 2] < 1.0)
            & (upright_tail.amin(dim=0) > 0.6))


def per_gait_stats(env_state, metrics, ids: torch.Tensor, n_g: int, num_ticks: int) -> dict:
    """Segment-wise reduction by gait id (a one-hot product): (n_g,)
    ``survival_frac``, ``mean_vel_err`` over the last quarter, and
    ``fwd_disp_m``."""
    onehot = torch.nn.functional.one_hot(ids.long(), n_g).float()      # (B,n_g)
    count = torch.clamp(onehot.sum(dim=0), min=1.0)
    per = lambda v: (v @ onehot) / count
    tail = metrics["vel_err"][-num_ticks // 4:]
    alive = _alive(env_state, metrics, num_ticks) & ~metrics["diverged"].any(dim=0)
    return {
        "survival_frac": per(alive.float()),
        "mean_vel_err": per(tail.mean(dim=0)),
        "fwd_disp_m": per(env_state.pos[:, 0]),
    }


def gait_sweep(
    robot_b: RobotParams,
    mpc: MpcParams,
    names: list[str],
    num_ticks: int,
    mesh=None,
    solver: str = ctrl.DEFAULT_SOLVER,
):
    """Closed-loop mixed-gait sweep with per-gait survival/tracking stats.

    Returns ``(env_state, per_gait)``, ``per_gait[name]`` holding the scalar
    ``survival_frac``, ``mean_vel_err`` and ``fwd_disp_m`` of that gait's
    scenarios (no auto-reset, so a fall counts)."""
    _single_card(mesh)
    B = robot_b.mass.shape[0]
    gait_b, cmd_b, ids = mixed_gait_batch(names, B, robot_b.mass.device)
    (env_state, _), metrics = srb_env.rollout(
        robot_b, mpc, gait_b, cmd_b, num_ticks, solver=solver, auto_reset=False,
    )
    stats = per_gait_stats(env_state, metrics, ids, len(names), num_ticks)
    per_gait = {n: {k: float(v[i]) for k, v in stats.items()} for i, n in enumerate(names)}
    return env_state, per_gait


def randomized_robots(robot: RobotParams, batch: int, generator: torch.Generator,
                      mass_scale=0.2, inertia_scale=0.2) -> RobotParams:
    """Domain-randomized robot batch: log-uniform mass and inertia factors in
    [exp(-scale), exp(scale)], drawn from ``generator`` (on the robot's
    device)."""
    tile = tree.tile(robot, batch)
    dev = robot.mass.device
    u = lambda: torch.rand(batch, generator=generator, dtype=torch.float32, device=dev)
    mass_f = torch.exp(-mass_scale + u() * (2.0 * mass_scale))
    inertia_f = torch.exp(-inertia_scale + u() * (2.0 * inertia_scale))
    tile.mass = tile.mass * mass_f
    tile.inertia = tile.inertia * inertia_f[:, None, None]
    return tile


def solve_sweep_step(
    robot: RobotParams,
    mpc: MpcParams,
    x_t: torch.Tensor,
    yaw: torch.Tensor,
    pos_base_feet: torch.Tensor,
    X_ref: torch.Tensor,
    gait_table: torch.Tensor,
    solver: str = "admm",
    return_diagnostics: bool = False,
):
    """One batched MPC solve step (``engine.solve_scenarios``); with
    ``return_diagnostics`` the per-scenario QP health telemetry rides along."""
    return engine.solve_scenarios(
        robot, mpc, x_t, yaw, pos_base_feet, X_ref, gait_table, solver=solver,
        return_diagnostics=return_diagnostics,
    )


def rollout_sweep(
    robot_b: RobotParams,
    mpc: MpcParams,
    gait_b: GaitParams,
    cmd_b: Command,
    num_ticks: int,
    mesh=None,
    solver: str = ctrl.DEFAULT_SOLVER,
):
    """Closed-loop sweep reduced to scalar metrics over the last quarter:
    ``mean_vel_err``, ``max_vel_err`` and ``survival_frac`` (0-d tensors).
    Returns (final_states, summary)."""
    _single_card(mesh)
    (env_state, _), metrics = srb_env.rollout(robot_b, mpc, gait_b, cmd_b, num_ticks,
                                              solver=solver)
    tail = metrics["vel_err"][-num_ticks // 4:]
    summary = {
        "mean_vel_err": tail.mean(),
        "max_vel_err": tail.max(),
        "survival_frac": _alive(env_state, metrics, num_ticks).float().mean(),
    }
    return env_state, summary
