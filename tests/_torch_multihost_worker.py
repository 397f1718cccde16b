"""One rank of tests/test_torch_parallel.py's two-process run of the port.

Run as:  python tests/_torch_multihost_worker.py <rank> <nprocs> <port> <outdir>

Each process is one gloo rank on the CPU (``launch.init_distributed``
over a local coordinator).  It reads the test's seeded inputs from
``<outdir>/inputs.npz``, drives the sharded paths of
``pympc_quadruped_tpu_torch.parallel`` and writes what it saw to
``<outdir>/result_<rank>.pt`` (tensors, numbers and strings only, read
back with ``weights_only=True``); the test compares the ranks with each
other, with one process and with JAX.  Imports torch and the port only.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NAMES = ["trotting10", "pacing10", "bounding8"]
#: Batch, ticks and solver of the closed-loop sweeps (3 scenarios per rank).
SWEEP_B, SWEEP_T, SWEEP_SOLVER = 6, 60, "riccati"
#: Steps kept and saves made by the two-rank retention check.
KEEP, SAVES = 3, 5
#: The spans and counters of ``parallel/`` (utils/profiling.py).
TRACED = ("launch.", "mesh.", "ckpt.")


def _error_text(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _traced(profiling) -> dict:
    """The spans (each sample's parent) and counters of ``parallel/`` that
    the registry holds."""
    snap = profiling.snapshot()
    return {"spans": {k: list(c["parent"]) for k, c in snap["spans"].items()
                      if k.startswith(TRACED)},
            "counters": {k: v for k, v in snap["counters"].items() if k.startswith(TRACED)}}


def _retention(directory: str, U: torch.Tensor) -> None:
    """One global_mean, then SAVES async saves at ``keep=KEEP`` and a close."""
    from pympc_quadruped_tpu_torch.parallel import launch, mesh as mesh_lib
    from pympc_quadruped_tpu_torch.parallel.checkpoint import SweepCheckpointer

    mesh_lib.global_mean(U, launch.global_data_mesh("cpu"))
    ck = SweepCheckpointer(directory, keep=KEEP)
    for step in range(1, SAVES + 1):
        ck.save(step, {"U": U + step, "tick": torch.tensor(step, dtype=torch.int32)})
    ck.close()


def main(rank: int, nprocs: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    from pympc_quadruped_tpu_torch import engine, tree
    from pympc_quadruped_tpu_torch.env import srb_env
    from pympc_quadruped_tpu_torch.models import aliengo, default_mpc_params
    from pympc_quadruped_tpu_torch.parallel import launch, mesh as mesh_lib, sweep
    from pympc_quadruped_tpu_torch.parallel.checkpoint import SweepCheckpointer, read_step
    from pympc_quadruped_tpu_torch.utils import profiling

    out = {"backend": launch.init_distributed(f"localhost:{port}", nprocs, rank,
                                              device="cpu")}
    out["join_traced"] = _traced(profiling)
    mesh = launch.global_data_mesh("cpu")
    out.update(rank=mesh.rank, size=mesh.size, per_host_batch=launch.per_host_batch(8),
               per_host_error=_error_text(lambda: launch.per_host_batch(7)),
               shard_error=_error_text(
                   lambda: mesh_lib.shard_global_batch(torch.zeros(7), mesh)))
    data = np.load(os.path.join(outdir, "inputs.npz"))
    cpu = torch.device("cpu")

    # Collectives: this rank's values are rank-dependent.
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * rank
    out["sum"] = mesh_lib.global_sum({"x": x, "n": torch.tensor(rank + 1)}, mesh)
    out["max"] = mesh_lib.global_max(x, mesh)
    out["mean"] = mesh_lib.global_mean(x, mesh)

    # Sharded solve against this rank's unsharded solve of the global batch.
    inputs = [torch.tensor(data[k]) for k in ("x_t", "yaw", "feet", "X_ref", "table")]
    B, h = inputs[0].shape[0], int(data["h"])
    robot, mpc = tree.tile(aliengo(cpu), B), default_mpc_params(h, device=cpu)
    sharded = mesh_lib.shard_global_batch((robot, *inputs), mesh)
    for solver in ("admm", "riccati"):
        out[f"U_full_{solver}"] = sweep.solve_sweep_step(robot, mpc, *inputs, solver=solver)
        U = sweep.solve_sweep_step(sharded[0], mpc, *sharded[1:], solver=solver)
        out[f"U_{solver}"] = U
        # The same solve's whole horizon, for the f64 cost against JAX.
        out[f"U_horizon_{solver}"] = engine.solve_scenarios(
            sharded[0], mpc, *sharded[1:], solver=solver, return_full_horizon=True)
        out[f"mean_abs_{solver}"] = mesh_lib.global_mean(U.abs(), mesh)

    # gait_sweep's reduction over a fixed (fake) rollout result, sharded.
    Bf, Tf = data["pos"].shape[0], data["vel_err"].shape[0]
    rows = mesh_lib.batch_sharding(mesh).rows(Bf)
    real_rollout = sweep.srb_env.rollout

    def fake_rollout(robot_b, *a, **k):
        state = srb_env.default_init_state(robot_b)
        state.pos = torch.tensor(data["pos"][rows])
        return (state, None), {k_: torch.tensor(data[k_][:, rows])
                               for k_ in ("vel_err", "height", "upright", "diverged")}

    sweep.srb_env.rollout = fake_rollout
    try:
        _, per_gait = sweep.gait_sweep(tree.tile(aliengo(cpu), Bf), default_mpc_params(10, cpu),
                                       NAMES, Tf, mesh=mesh)
    finally:
        sweep.srb_env.rollout = real_rollout
    out["fake_per_gait"] = per_gait

    # The closed-loop sweeps, sharded (SWEEP_SOLVER: see the test).
    mpc10 = default_mpc_params(10, device=cpu)
    robot_s = tree.tile(aliengo(cpu), SWEEP_B)
    gait_b, cmd_b, _ = sweep.mixed_gait_batch(NAMES, SWEEP_B, device=cpu)
    state, summary = sweep.rollout_sweep(robot_s, mpc10, gait_b, cmd_b, SWEEP_T, mesh=mesh,
                                         solver=SWEEP_SOLVER)
    out["rollout_summary"], out["rollout_pos"] = summary, state.pos
    state, per_gait = sweep.gait_sweep(robot_s, mpc10, NAMES, SWEEP_T, mesh=mesh,
                                       solver=SWEEP_SOLVER)
    out["gait_summary"], out["gait_pos"] = per_gait, state.pos

    # A checkpoint of sharded rows and a replicated tick, across the ranks.
    U = out["U_admm"]
    ck = SweepCheckpointer(os.path.join(outdir, "ckpt"), keep=1, async_save=False)
    ck.save(1, {"U": U, "step_count": mesh_lib.replicate(torch.tensor(7, dtype=torch.int32),
                                                           mesh)})
    ck.wait()
    zeros = {"U": torch.zeros_like(U), "step_count": torch.tensor(0, dtype=torch.int32)}
    step, restored = ck.restore_or(zeros)
    out.update(ckpt_step=step, ckpt_U=restored["U"], ckpt_count=restored["step_count"])
    ck.close()
    ck = SweepCheckpointer(os.path.join(outdir, "ckpt"), keep=1)     # async
    ck.save(2, {"U": U + 1.0, "step_count": torch.tensor(8, dtype=torch.int32)})
    ck.close()
    step, restored = ck.restore_or(zeros)
    out.update(ckpt_step2=step, ckpt_U2=restored["U"], ckpt_count2=restored["step_count"],
               ckpt_steps=sorted(int(p) for p in os.listdir(ck.directory)))

    # Retention at keep=KEEP over SAVES saves, traced; then the same untraced.
    keep_dir = os.path.join(outdir, "keep")
    profiling.reset()
    _retention(keep_dir, U)
    out["keep_traced"] = _traced(profiling)
    out["keep_files"] = {int(p): sorted(os.listdir(os.path.join(keep_dir, p)))
                         for p in os.listdir(keep_dir)}
    newest, files = read_step(keep_dir)
    out.update(keep_newest=newest, keep_U=files[rank]["U"], keep_tick=files[rank]["tick"])
    profiling.reset()
    profiling.set_enabled(False)
    try:
        _retention(os.path.join(outdir, "keep_off"), U)
    finally:
        profiling.set_enabled(True)
    out["keep_off_traced"] = _traced(profiling)

    torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(outdir, f"result_{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
