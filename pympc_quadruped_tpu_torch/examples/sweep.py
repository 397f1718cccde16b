"""Production scenario sweep (port of ``examples/sweep.py``): thousands of
lockstep scenarios, sharded over one process per card.

Randomizes robot mass and inertia across the batch, closes the loop in the
SRB environment (optionally on terrain, optionally driven by the Kalman
filter instead of ground truth), reduces metrics across the ranks, logs
through ``MetricsLogger`` and checkpoints the whole sweep state for
resume.  Runs on the card unless ``--device cpu`` is given.

One process:

    python -m pympc_quadruped_tpu_torch.examples.sweep --batch 1024 --seconds 2
    python -m pympc_quadruped_tpu_torch.examples.sweep --device cpu --batch 8 --seconds 0.3

One process per card (torchrun sets ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; ``--batch`` is the global
batch):

    torchrun --nproc-per-node 4 -m pympc_quadruped_tpu_torch.examples.sweep --batch 65536

Preemption: ``--ckpt-dir D --stop-after-chunks N`` stops after N chunks;
running again with the same ``--ckpt-dir`` resumes from the last chunk
saved and ends bitwise where an uninterrupted run ends.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256, help="global scenario count")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--robot", choices=["aliengo", "a1"], default="aliengo")
    ap.add_argument("--vx", type=float, default=1.0)
    ap.add_argument("--terrain", choices=["none", "rough", "slope"], default="none")
    ap.add_argument("--estimator", action="store_true", help="drive via the KF")
    ap.add_argument("--contact-source", choices=["plan", "measured"],
                    default="plan", dest="contact_source",
                    help="KF leg-odometry gate: planned stance schedule or "
                         "touch synthesized from held GRFs (see srb_env.rollout)")
    ap.add_argument("--chunk-ticks", type=int, default=500)
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint/resume directory")
    ap.add_argument("--stop-after-chunks", type=int, default=None,
                    help="exit after N chunks (simulated preemption; resume "
                         "by re-running with the same --ckpt-dir)")
    ap.add_argument("--gaits", default=None,
                    help="comma-separated gait names for a mixed-gait sweep, e.g. "
                         "trotting10,pacing10,bounding8; overrides the single-gait "
                         "default and prints per-gait stats")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

    from pympc_quadruped_tpu_torch import tree
    from pympc_quadruped_tpu_torch.env import srb_env, terrain as terrain_lib
    from pympc_quadruped_tpu_torch.estimation import kf
    from pympc_quadruped_tpu_torch.models import Command, Gaits, a1, aliengo, default_mpc_params
    from pympc_quadruped_tpu_torch.parallel import launch, mesh as mesh_lib, sweep
    from pympc_quadruped_tpu_torch.utils.observability import MetricsLogger

    backend = launch.init_distributed(device=args.device)
    mesh = launch.global_data_mesh(args.device)
    dev = mesh.device
    B = args.batch
    first_row = mesh_lib.batch_sharding(mesh).rows(B).start
    print(f"devices={mesh.size} hosts={mesh.size} batch={B} rank={mesh.rank} "
          f"backend={backend or 'none'} device={dev}", flush=True)

    mpc = default_mpc_params(10, device=dev)
    base = aliengo(dev) if args.robot == "aliengo" else a1(dev)
    # Every rank draws the same global batch from the seed, then keeps its rows.
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    robot_b = sweep.randomized_robots(base, B, gen)
    gait_ids = None
    if args.gaits:
        gait_names = args.gaits.split(",")
        gait_b, cmd_b, gait_ids = sweep.mixed_gait_batch(gait_names, B, dev)
    else:
        gait_b = tree.tile(Gaits.trotting10(dev), B)
        cmd_b = tree.tile(Command.trot_forward(args.vx, dev), B)

    terrain_b = None
    if args.terrain != "none":
        if args.terrain == "rough":
            one = terrain_lib.random_rough(torch.Generator(device=dev).manual_seed(7),
                                           amplitude=0.02, device=dev)
        else:
            one = terrain_lib.slope(0.15, device=dev)
        terrain_b = mesh_lib.shard_global_batch(tree.tile(one, B), mesh)

    robot_b, gait_b, cmd_b = mesh_lib.shard_global_batch((robot_b, gait_b, cmd_b), mesh)
    if gait_ids is not None:
        gait_ids = mesh_lib.shard_global_batch(gait_ids, mesh)
    est = kf.KfParams.default(device=dev) if args.estimator else None

    # The WHOLE loop state is one tree: env states, controller carries (with
    # the QP warm starts), KF states and held forces, the absolute tick.
    # Chunks thread it; the checkpoint holds it; resume continues bitwise.
    if terrain_b is not None:
        env0 = srb_env.init_state_on_terrain(robot_b, terrain_b)
    else:
        env0 = srb_env.default_init_state(robot_b)
    sweep_state = {
        "env": env0,
        "carry": srb_env.init_full_carry(robot_b, mpc, env0, est),
        "tick": mesh_lib.replicate(torch.tensor(0, dtype=torch.int32), mesh),
    }

    def run_chunk(sweep_state):
        (state, carry), metrics = srb_env.rollout(
            robot_b, mpc, gait_b, cmd_b, num_ticks=args.chunk_ticks,
            init_state=sweep_state["env"], carry_in=sweep_state["carry"],
            tick0=int(sweep_state["tick"]), terrain=terrain_b, estimator=est,
            key=args.seed, return_full_carry=True, contact_source=args.contact_source,
            noise_rows=(first_row, B),
        )
        tail = metrics["vel_err"][-args.chunk_ticks // 4:]
        means = {"mean_vel_err": tail, "mean_height": metrics["height"][-1]}
        if est is not None:
            means["mean_est_vel_err"] = metrics["est_vel_err"]
            if args.contact_source == "measured":
                means["mean_contact_mismatch"] = metrics["contact_mismatch"]
        means = mesh_lib.global_mean(means, mesh)
        out = {
            "mean_vel_err": means.pop("mean_vel_err"),
            "max_vel_err": mesh_lib.global_max(tail, mesh),
            "mean_height": means.pop("mean_height"),
            "divergence_events": mesh_lib.global_sum(
                metrics["diverged"].sum(dtype=torch.int32), mesh),
            **means,
        }
        new_state = {"env": state, "carry": carry,
                     "tick": sweep_state["tick"] + args.chunk_ticks}
        return new_state, out, metrics

    ckpt = None
    start_chunk = 0
    if args.ckpt_dir:
        from pympc_quadruped_tpu_torch.parallel.checkpoint import SweepCheckpointer

        ckpt = SweepCheckpointer(args.ckpt_dir, keep=2)
        start_chunk, sweep_state = ckpt.restore_or(sweep_state)
        if start_chunk:
            print(f"resuming at chunk {start_chunk} (tick {int(sweep_state['tick'])})",
                  flush=True)

    logger = MetricsLogger()
    n_chunks = max(1, int(args.seconds * 1000) // args.chunk_ticks)
    stop_at = n_chunks if args.stop_after_chunks is None else min(
        n_chunks, start_chunk + args.stop_after_chunks
    )
    metrics = None
    t0 = time.time()
    for c in range(start_chunk, stop_at):
        sweep_state, summary, metrics = run_chunk(sweep_state)
        logger.append(summary)
        if ckpt is not None:
            ckpt.save(c + 1, sweep_state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    series = logger.drain()
    if ckpt is not None:
        ckpt.close()

    ticks = (stop_at - start_chunk) * args.chunk_ticks
    print(f"chunks={stop_at}/{n_chunks} wall={wall:.1f}s "
          f"ticks/s={B * ticks / max(wall, 1e-9):,.0f}")
    for k, v in series.items():
        print(f"  {k}: last={float(v[-1]):.4f} mean={float(np.mean(v)):.4f}")

    if gait_ids is not None and stop_at == n_chunks and metrics is not None:
        # Per-gait survival and tracking over the final chunk, reduced over
        # every rank's scenarios (the same lines on every rank).
        stats = sweep.per_gait_stats(sweep_state["env"], metrics, gait_ids, len(gait_names),
                                     args.chunk_ticks, mesh)
        for i, name in enumerate(gait_names):
            print(f"  gait {name}: n={int(stats['count'][i])} "
                  f"survival={float(stats['survival_frac'][i]):.3f} "
                  f"mean_vel_err={float(stats['mean_vel_err'][i]):.4f} "
                  f"fwd_disp_m={float(stats['fwd_disp_m'][i]):.2f}")
    if backend is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
