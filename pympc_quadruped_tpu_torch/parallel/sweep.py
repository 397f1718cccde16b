"""Scenario sweep runners, sharded over the ``"data"`` mesh (port of
``parallel/sweep.py``).

The production surface for the gait sweep, domain randomization and the
command sweep: build a global scenario batch (the same on every rank),
shard it (:mod:`.mesh`), and run either :func:`solve_sweep_step` (one
batched condense + solve on the rows the caller placed, the benchmark
unit) or :func:`rollout_sweep` / :func:`gait_sweep` (closed-loop SRB
rollouts of this rank's rows, reduced to global sweep metrics by
collectives over the ranks).  With one process the mesh is one rank and
nothing is exchanged.
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
from pympc_quadruped_tpu_torch.parallel import mesh as mesh_lib


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
    The gaits share leaf shapes, so mixing them is stacking leaves.  Made
    for the global batch, then sharded: scenario i runs gait i % len(names)
    on whichever rank holds it."""
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


def per_gait_stats(env_state, metrics, ids: torch.Tensor, n_g: int, num_ticks: int,
                   mesh: mesh_lib.DataMesh) -> dict:
    """Segment-wise reduction by gait id (a one-hot product): (n_g,)
    ``survival_frac``, ``mean_vel_err`` over the last quarter,
    ``fwd_disp_m``, and ``count``, each gait's scenarios.  The per-gait
    sums and counts are float64 and summed over ``mesh``'s ranks before the
    one division, so the result is the global batch's, the same on every
    rank."""
    onehot = torch.nn.functional.one_hot(ids.long(), n_g).double()     # (B,n_g)
    tail = metrics["vel_err"][-num_ticks // 4:]
    alive = _alive(env_state, metrics, num_ticks) & ~metrics["diverged"].any(dim=0)
    sums = {
        "survival_frac": alive.double() @ onehot,
        "mean_vel_err": tail.double().mean(dim=0) @ onehot,
        "fwd_disp_m": env_state.pos[:, 0].double() @ onehot,
        "count": onehot.sum(dim=0),
    }
    sums = mesh_lib.global_sum(sums, mesh)
    count = sums.pop("count")
    stats = {k: (v / torch.clamp(count, min=1.0)).float() for k, v in sums.items()}
    return {**stats, "count": count.float()}


def gait_sweep(
    robot_b: RobotParams,
    mpc: MpcParams,
    names: list[str],
    num_ticks: int,
    mesh=None,
    solver: str = ctrl.DEFAULT_SOLVER,
):
    """Closed-loop mixed-gait sweep with per-gait survival/tracking stats.

    ``robot_b`` is the global batch, the same on every rank; ``mesh``
    (default: :func:`.mesh.data_mesh` on the robot's device) shards it.
    Returns ``(env_state, per_gait)``: this rank's rows of the final state,
    and ``per_gait[name]`` holding the scalar ``survival_frac``,
    ``mean_vel_err`` and ``fwd_disp_m`` of that gait's scenarios over the
    whole batch (no auto-reset, so a fall counts), the same on every rank."""
    if mesh is None:
        mesh = mesh_lib.data_mesh(robot_b.mass.device)
    B = robot_b.mass.shape[0]
    gait_b, cmd_b, ids = mixed_gait_batch(names, B, robot_b.mass.device)
    robot_b, gait_b, cmd_b, ids = mesh_lib.shard_batch((robot_b, gait_b, cmd_b, ids), mesh)
    (env_state, _), metrics = srb_env.rollout(
        robot_b, mesh_lib.replicate(mpc, mesh), gait_b, cmd_b, num_ticks, solver=solver,
        auto_reset=False,
    )
    stats = per_gait_stats(env_state, metrics, ids, len(names), num_ticks, mesh)
    stats.pop("count")
    per_gait = {n: {k: float(v[i]) for k, v in stats.items()} for i, n in enumerate(names)}
    return env_state, per_gait


def randomized_robots(robot: RobotParams, batch: int, generator: torch.Generator,
                      mass_scale=0.2, inertia_scale=0.2) -> RobotParams:
    """Domain-randomized robot batch: log-uniform mass and inertia factors in
    [exp(-scale), exp(scale)], drawn from ``generator`` (on the robot's
    device).  Every rank draws the same global batch from the same seed,
    then keeps its rows (:func:`.mesh.shard_global_batch`)."""
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
    """One batched MPC solve step (``engine.solve_scenarios``) on whatever
    rows the caller placed (shard them with :func:`.mesh.shard_global_batch`);
    with ``return_diagnostics`` the per-scenario QP health telemetry rides
    along."""
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

    The arguments are the global batch, the same on every rank; ``mesh``
    (default: :func:`.mesh.data_mesh` on the robot's device) shards it, and
    the summary reduces sums, counts and the max over the ranks, so every
    rank returns the global summary with its own rows of the final states.
    Returns (final_states, summary)."""
    if mesh is None:
        mesh = mesh_lib.data_mesh(robot_b.mass.device)
    robot_b, gait_b, cmd_b = mesh_lib.shard_batch((robot_b, gait_b, cmd_b), mesh)
    (env_state, _), metrics = srb_env.rollout(robot_b, mesh_lib.replicate(mpc, mesh), gait_b,
                                              cmd_b, num_ticks, solver=solver)
    tail = metrics["vel_err"][-num_ticks // 4:]
    means = mesh_lib.global_mean({
        "mean_vel_err": tail,
        "survival_frac": _alive(env_state, metrics, num_ticks).float(),
    }, mesh)
    summary = {
        "mean_vel_err": means["mean_vel_err"],
        "max_vel_err": mesh_lib.global_max(tail, mesh),
        "survival_frac": means["survival_frac"],
    }
    return env_state, summary
