"""Headless plots and animations (port of ``utils/viz.py``).

The counterparts of the reference's viewer GIF and its matplotlib debug
plot of the predicted CoM trajectory (ref ``linear_mpc/mpc.py:293-318``),
drawn with matplotlib's Agg backend, so no display is needed:

- :func:`plot_predicted_com`: the condensed prediction ``X = Sx x_t + Su U``
  against the reference trajectory;
- :func:`plot_rollout_metrics`: a batched rollout's height, velocity error
  and divergence count over time;
- :func:`gait_diagram`: per-leg stance bars over time;
- :func:`animate_trot`: a side-view stick-figure GIF of a recorded trace
  (the keys ``examples/mujoco_closed_loop.py --record`` writes).

Every function takes tensors on any device (they are moved to the CPU) or
numpy arrays, saves to ``path`` and returns it.  matplotlib is imported
inside the functions: no module on the controller's path imports this one.
"""
from __future__ import annotations

import numpy as np
import torch

from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.models.mpc import NUM_STATE, MpcParams
from pympc_quadruped_tpu_torch.models.robots import LEG_NAMES, RobotParams


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _numpy(x) -> np.ndarray:
    """A tensor on any device, an array or numbers, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _cpu32(x) -> torch.Tensor:
    return torch.as_tensor(np.array(_numpy(x), dtype=np.float32))


def plot_predicted_com(
    robot: RobotParams,
    mpc: MpcParams,
    x_t,
    yaw,
    pos_base_feet,
    X_ref,
    U,
    path: str,
) -> str:
    """Predicted CoM trajectory from the condensed model against the
    reference (ref ``mpc.py:293-318``): X = Sx x_t + Su U over the horizon,
    for one scenario (``x_t`` (13,), ``yaw`` scalar, ``pos_base_feet``
    (4,3), ``X_ref`` (13h,), ``U`` (12h,))."""
    from pympc_quadruped_tpu_torch.ops import condense, srb

    plt = _pyplot()
    one = lambda t: t.cpu()[None]
    robot_1, mpc_c = tree.tree_map(one, robot), tree.to(mpc, "cpu")
    Ad, Bd = srb.discretize(*srb.state_space(robot_1, _cpu32(yaw).reshape(1),
                                             _cpu32(pos_base_feet)[None]), mpc_c.dt_predict)
    Sx, Su = condense.rollout_matrices(Ad, Bd, mpc.horizon)
    X = (Sx[0] @ _cpu32(x_t) + Su[0] @ _cpu32(U)).numpy().reshape(mpc.horizon, NUM_STATE)
    Xr = _numpy(X_ref).reshape(mpc.horizon, NUM_STATE)

    fig, axes = plt.subplots(2, 3, figsize=(11, 6), sharex=True)
    steps = np.arange(mpc.horizon)
    labels = [("x", 3), ("y", 4), ("z", 5), ("roll", 0), ("pitch", 1), ("yaw", 2)]
    for ax, (name, idx) in zip(axes.flat, labels):
        ax.plot(steps, X[:, idx], "o-", label="predicted", ms=3)
        ax.plot(steps, Xr[:, idx], "s--", label="reference", ms=3)
        ax.set_title(name)
        ax.grid(alpha=0.3)
    axes[0, 0].legend(loc="best", fontsize=8)
    fig.suptitle("Condensed-model CoM prediction vs reference trajectory")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_rollout_metrics(metrics: dict, path: str, dt: float = 0.001) -> str:
    """Curves from a rollout's metrics: per-tick (T, B) tensors or arrays."""
    plt = _pyplot()
    h = _numpy(metrics["height"])
    v = _numpy(metrics["vel_err"])
    d = _numpy(metrics["diverged"])
    t = np.arange(h.shape[0]) * dt

    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for arr, ax, name in ((h, axes[0], "base height [m]"), (v, axes[1], "|v - v_des| [m/s]")):
        mean = arr.mean(axis=1)
        lo, hi = arr.min(axis=1), arr.max(axis=1)
        ax.plot(t, mean, lw=1.2, label="batch mean")
        ax.fill_between(t, lo, hi, alpha=0.25, label="batch min..max")
        ax.set_ylabel(name)
        ax.grid(alpha=0.3)
    axes[0].legend(fontsize=8)
    axes[2].plot(t, d.sum(axis=1), lw=1.0, color="tab:red")
    axes[2].set_ylabel("# diverged")
    axes[2].set_xlabel("time [s]")
    axes[2].grid(alpha=0.3)
    if "est_pos_err" in metrics:
        axes[1].plot(
            t, _numpy(metrics["est_pos_err"]).mean(axis=1),
            lw=1.0, ls="--", label="KF pos err",
        )
        axes[1].legend(fontsize=8)
    fig.suptitle("Closed-loop sweep metrics")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def gait_diagram(gait, mpc: MpcParams, num_ticks: int, path: str) -> str:
    """Stance (filled) / swing (empty) bars per leg over time."""
    from pympc_quadruped_tpu_torch.ops import gaitsched

    plt = _pyplot()
    ticks = torch.arange(num_ticks, dtype=torch.int32)
    swing = gaitsched.swing_state(tree.to(gait, "cpu"), tree.to(mpc, "cpu"), ticks).numpy()
    stance = swing == 0.0                                     # (T, 4)
    t = np.arange(num_ticks) * float(mpc.dt_control)

    fig, ax = plt.subplots(figsize=(9, 2.4))
    for leg in range(4):
        on = stance[:, leg]
        edges = np.flatnonzero(np.diff(on.astype(np.int8))) + 1
        bounds = np.concatenate([[0], edges, [num_ticks]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            if on[a]:
                ax.barh(leg, t[b - 1] - t[a], left=t[a], height=0.6,
                        color="tab:blue", alpha=0.85)
    ax.set_yticks(range(4), LEG_NAMES)
    ax.set_xlabel("time [s]")
    ax.set_title("Gait diagram (filled = stance)")
    ax.grid(alpha=0.3, axis="x")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def animate_trot(
    trace: dict,
    robot: RobotParams,
    path: str,
    fps: int = 25,
    stride: int = 40,
) -> str:
    """Side-view stick-figure animation of a recorded trot -> GIF.

    ``trace`` holds per-tick ``obs_pos`` (T,3), ``obs_quat`` (T,4) and
    ``obs_q`` (T,12): the keys ``examples/mujoco_closed_loop.py --record``
    writes, in either framework.  The trunk and the FK'd legs are drawn in
    the world x-z plane."""
    from matplotlib import animation

    from pympc_quadruped_tpu_torch.ops import kin, lie

    plt = _pyplot()
    pos = _numpy(trace["obs_pos"])[::stride]
    quat = _numpy(trace["obs_quat"])[::stride]
    q = _numpy(trace["obs_q"])[::stride]
    T = pos.shape[0]

    robot_c = tree.to(robot, "cpu")
    R_all = lie.quat_to_rotmat(_cpu32(quat)).numpy()
    p_bf, _ = kin.leg_forward_kinematics(robot_c, _cpu32(q).reshape(T, 4, 3))
    feet_w = pos[:, None, :] + np.einsum("tij,tlj->tli", R_all, p_bf.numpy())
    hip_offset = robot_c.hip_offset.numpy()
    hips_w = pos[:, None, :] + np.einsum("tij,lj->tli", R_all, hip_offset)
    half = float(hip_offset[0, 0])

    fig, ax = plt.subplots(figsize=(7, 3))
    ax.set_ylim(-0.02, 0.7)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title("trot (stick view)")
    ax.axhline(0.0, color="k", lw=1)
    trunk_line, = ax.plot([], [], lw=5, color="tab:gray")
    leg_lines = [ax.plot([], [], lw=2, color=c)[0]
                 for c in ("tab:blue", "tab:orange", "tab:green", "tab:red")]
    foot_dots, = ax.plot([], [], "ko", ms=4)

    def frame(i):
        c = pos[i]
        fore = c + R_all[i] @ np.array([half, 0.0, 0.0])
        aft = c + R_all[i] @ np.array([-half, 0.0, 0.0])
        trunk_line.set_data([aft[0], fore[0]], [aft[2], fore[2]])
        for leg in range(4):
            hp, fp = hips_w[i, leg], feet_w[i, leg]
            leg_lines[leg].set_data([hp[0], fp[0]], [hp[2], fp[2]])
        foot_dots.set_data(feet_w[i, :, 0], feet_w[i, :, 2])
        ax.set_xlim(c[0] - 0.8, c[0] + 0.8)
        return [trunk_line, *leg_lines, foot_dots]

    anim = animation.FuncAnimation(fig, frame, frames=T, blit=False)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path
