"""Record a short trot and render every visual artifact, headless (port of
``examples/visualize.py``).

Writes, under ``--out`` (default ./viz_out):

    trace.npz, trot.gif  the MuJoCo trot driven by the port's controller,
                         and its stick-figure animation
    trot_rendered.gif    the same run rendered offscreen by MuJoCo
    gait.png             TROTTING10's stance/swing diagram
    rollout.png          a batched ``srb_env.rollout``'s metric curves
    predicted_com.png    the predicted-CoM debug plot of one engine solve

    python -m pympc_quadruped_tpu_torch.examples.visualize --seconds 2
    python -m pympc_quadruped_tpu_torch.examples.visualize --device cpu --seconds 1
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="viz_out")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--robot", choices=["aliengo", "a1"], default="aliengo")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dev = args.device

    import numpy as np
    import torch

    from pympc_quadruped_tpu_torch import engine, tree
    from pympc_quadruped_tpu_torch.env import srb_env
    from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import run
    from pympc_quadruped_tpu_torch.models import Command, Gaits, a1, aliengo, default_mpc_params
    from pympc_quadruped_tpu_torch.ops import gaitsched
    from pympc_quadruped_tpu_torch.utils import viz

    robot1 = aliengo(device=dev) if args.robot == "aliengo" else a1(device=dev)
    mpc = default_mpc_params(10, device=dev)
    gait = Gaits.trotting10(device=dev)

    # 1. Record a trot, animate it (stick figure) and render it offscreen.
    trace_path = os.path.join(args.out, "trace.npz")
    rendered = os.path.join(args.out, "trot_rendered.gif")
    run(seconds=args.seconds, robot=args.robot, record=trace_path, verbose=False,
        render=rendered, device=dev)
    trace = dict(np.load(trace_path))
    print("wrote", viz.animate_trot(trace, robot1, os.path.join(args.out, "trot.gif")))
    print("wrote", rendered)

    # 2. Gait diagram.
    print("wrote", viz.gait_diagram(gait, mpc, 2000, os.path.join(args.out, "gait.png")))

    # 3. Batched SRB rollout metrics.
    B = 4
    _, metrics = srb_env.rollout(tree.tile(robot1, B), mpc, tree.tile(gait, B),
                                 tree.tile(Command.trot_forward(1.0, device=dev), B),
                                 num_ticks=400)
    print("wrote", viz.plot_rollout_metrics(metrics, os.path.join(args.out, "rollout.png")))

    # 4. Predicted-CoM debug plot from one engine solve.
    f32 = dict(dtype=torch.float32, device=dev)
    x_t = torch.zeros(13, **f32)
    x_t[5], x_t[9], x_t[12] = 0.38, 1.0, -9.81
    feet = torch.tensor([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                         [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]], **f32)
    X_ref = torch.zeros((10, 13), **f32)
    X_ref[:, 3] = 0.05 * torch.arange(10, **f32)
    X_ref[:, 5], X_ref[:, 9], X_ref[:, 12] = 0.38, 1.0, -9.81
    X_ref = X_ref.reshape(-1)
    table = gaitsched.gait_table(gait, mpc, 0)
    U = engine.solve_scenarios(
        tree.tile(robot1, 1), mpc, x_t[None], torch.zeros(1, **f32), feet[None], X_ref[None],
        table[None], solver="admm", return_full_horizon=True,
    )[0]
    print("wrote", viz.plot_predicted_com(robot1, mpc, x_t, 0.0, feet, X_ref, U,
                                          os.path.join(args.out, "predicted_com.png")))


if __name__ == "__main__":
    main()
