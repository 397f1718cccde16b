"""Tiled multi-robot viewer for batched full-order rollouts (port of
``examples/batch_viz.py``).

The batch runs on the card (``env/fullorder``, thousands of scenarios if
asked): one :class:`~..env.fullorder.RolloutLoop` for the whole run, so its
non-solve tick is captured as a CUDA graph once, and every
``frame_ticks`` ticks the scenarios' (pos, quat, q) are copied to the
host.  :func:`render_grid` then replays them into a render-only MuJoCo grid
scene (:func:`..env.mjcf.grid_model_xml`: one free body and 12 joints per
instance, no actuators or contacts) and writes a tiled GIF.

    python -m pympc_quadruped_tpu_torch.examples.batch_viz --n 9 --seconds 3 \\
        --out batch_grid.gif
    python -m pympc_quadruped_tpu_torch.examples.batch_viz --device cpu --n 9 --seconds 1

MuJoCo, imageio and PIL are imported inside :func:`render_grid` only.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

#: Scenario i runs GAITS[i % 3] (the same period structure at h=10).
GAITS = ("trotting10", "pacing10", "bounding8")


def batch_inputs(n: int, vx: float, device):
    """(robot, mpc, gait, cmd) of the grid: Aliengo at h=10, the gaits
    mixed across the rows and a ramp of speeds, 0.6-1.0 x ``vx``, down the
    grid."""
    from pympc_quadruped_tpu_torch import tree
    from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params

    mpc = default_mpc_params(10, device=device)
    robot = tree.tile(aliengo(device=device), n)
    gaits = [Gaits.by_name(g, device=device) for g in GAITS]
    gait = tree.tree_map(lambda *leaves: torch.stack([leaves[i % 3] for i in range(n)]), *gaits)
    vxs = [vx * (0.6 + 0.4 * (i // 3) / max(1, (n - 1) // 3)) for i in range(n)]
    vel = torch.zeros((n, 3), dtype=torch.float32)
    vel[:, 0] = torch.tensor(vxs, dtype=torch.float32)
    cmd = Command(vel_base_des=vel.to(device),
                  yaw_turn_rate=torch.zeros((n,), dtype=torch.float32, device=device))
    return robot, mpc, gait, cmd


def record_batch(n, seconds, frame_ticks=40, vx=0.6, device="cuda", return_metrics=False):
    """Run ``n`` mixed-gait full-order scenarios from the nominal stance on
    ``device``; return the frames, a list of host (pos (n,3), quat (n,4),
    q (n,12)) arrays, one after each ``frame_ticks`` ticks, for the frame
    starts ``range(0, seconds * 1000, frame_ticks)``.  With
    ``return_metrics``, also the loop's (ticks, n) metric tensors."""
    from pympc_quadruped_tpu_torch.env import fullorder
    from pympc_quadruped_tpu_torch.utils import profiling

    robot, mpc, gait, cmd = batch_inputs(n, vx, device)
    starts = range(0, int(seconds * 1000), frame_ticks)
    loop = fullorder.RolloutLoop(robot, mpc, gait, cmd, len(starts) * frame_ticks,
                                 traced=profiling.recording())
    frames = []
    for t0 in starts:
        for _ in range(frame_ticks):
            loop.step()
        s = loop.buf.state
        host = torch.cat([s.pos, s.quat, s.q], dim=-1).cpu().numpy()
        frames.append((host[:, :3], host[:, 3:7], host[:, 7:]))
        print(f"  t={t0 + frame_ticks} ms  mean height {host[:, 2].mean():.3f}",
              file=sys.stderr)
    if return_metrics:
        return frames, loop.buf.metrics
    return frames


def render_grid(frames, n, out, spacing=1.2, fps=25):
    """Replay ``frames`` into the render-only grid scene and write a GIF
    (through imageio, or PIL where imageio is missing)."""
    from pympc_quadruped_tpu_torch.env import mjcf
    from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import import_mujoco, write_gif

    mujoco = import_mujoco()

    model = mujoco.MjModel.from_xml_string(mjcf.grid_model_xml("aliengo", n, spacing))
    data = mujoco.MjData(model)
    renderer = mujoco.Renderer(model, height=480, width=640)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    cam = mujoco.MjvCamera()
    cam.lookat[:] = [(cols - 1) * spacing / 2, (rows - 1) * spacing / 2, 0.25]
    cam.distance = 1.35 * spacing * max(cols, rows)
    cam.azimuth = -120.0
    cam.elevation = -28.0
    images = []
    for pos, quat, q in frames:
        for i in range(n):
            base = i * 19
            gx, gy = (i % cols) * spacing, (i // cols) * spacing
            # Each instance walks in place at its grid cell (x/y wrapped
            # into the cell so the tiles stay tiled).
            data.qpos[base:base + 3] = [
                gx + float(pos[i, 0]) % (0.6 * spacing) - 0.3 * spacing,
                gy + float(pos[i, 1]) % (0.4 * spacing) - 0.2 * spacing,
                pos[i, 2],
            ]
            data.qpos[base + 3:base + 7] = quat[i]
            data.qpos[base + 7:base + 19] = q[i]
        mujoco.mj_forward(model, data)
        renderer.update_scene(data, camera=cam)
        images.append(renderer.render().copy())
    renderer.close()
    try:
        import imageio

        imageio.mimsave(out, images, duration=1000 / fps, loop=0)
    except ImportError:
        write_gif(out, images, fps, verbose=False)
    print(f"wrote {out} ({len(images)} frames, {n} robots)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=9)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="batch_grid.gif")
    ap.add_argument("--frame-ticks", type=int, default=40)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    frames = record_batch(args.n, args.seconds, args.frame_ticks, device=args.device)
    render_grid(frames, args.n, args.out, fps=1000 // args.frame_ticks)


if __name__ == "__main__":
    main()
