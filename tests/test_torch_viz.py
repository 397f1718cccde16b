"""The port's headless plots and animations (``utils/viz.py``).

tests/test_viz.py's three smoke checks, on the port's ``srb_env.rollout``
and ``plot_predicted_com``, and the trace format shared by the two
frameworks' MuJoCo examples: each framework's ``animate_trot`` draws the
other's recorded trace, frame for frame.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.utils import viz as jviz

from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import run
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.utils import viz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gait_diagram_and_rollout_plot(tmp_path):
    mpc = default_mpc_params(10, device="cpu")
    gait = Gaits.trotting10(device="cpu")
    p1 = viz.gait_diagram(gait, mpc, 800, str(tmp_path / "gait.png"))
    assert os.path.getsize(p1) > 2000

    B = 2
    _, metrics = srb_env.rollout(
        tree.tile(aliengo(device="cpu"), B), mpc, tree.tile(gait, B),
        tree.tile(Command.trot_forward(0.6, device="cpu"), B), num_ticks=120,
    )
    p2 = viz.plot_rollout_metrics(metrics, str(tmp_path / "rollout.png"))
    assert os.path.getsize(p2) > 2000


def test_predicted_com_plot(tmp_path):
    mpc = default_mpc_params(10, device="cpu")
    x_t = np.zeros(13, np.float32)
    x_t[5], x_t[12] = 0.38, -9.81
    feet = np.array([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                     [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]], np.float32)
    X_ref = np.zeros((10, 13), np.float32)
    X_ref[:, 5], X_ref[:, 12] = 0.38, -9.81
    # Tensors and numpy arrays mix freely.
    p = viz.plot_predicted_com(aliengo(device="cpu"), mpc, torch.from_numpy(x_t), 0.0, feet,
                               X_ref.reshape(-1), torch.zeros(120), str(tmp_path / "com.png"))
    assert os.path.getsize(p) > 2000


def test_animate_trot_gif(tmp_path):
    T = 30
    t = np.linspace(0, 0.6, T)
    trace = {
        "obs_pos": np.stack([0.5 * t, 0 * t, 0.38 + 0.01 * np.sin(8 * t)], axis=1),
        "obs_quat": np.tile([1.0, 0, 0, 0], (T, 1)),
        "obs_q": np.tile(np.tile([0.0, 0.8, -1.6], 4), (T, 1)) + 0.1 * np.sin(10 * t)[:, None],
    }
    p = viz.animate_trot(trace, aliengo(device="cpu"), str(tmp_path / "trot.gif"), stride=2)
    assert os.path.getsize(p) > 10000


def _frames(path):
    with Image.open(path) as im:
        return im.n_frames


@pytest.mark.parametrize("recorder", ["port", "jax"])
def test_animate_trot_reads_either_frameworks_trace(tmp_path, recorder):
    trace_path = str(tmp_path / "trace.npz")
    if recorder == "port":
        run(seconds=0.2, record=trace_path, verbose=False, device="cpu")
    else:
        sys.path.insert(0, os.path.join(REPO, "examples"))
        try:
            from mujoco_closed_loop import run as jax_run
        finally:
            sys.path.remove(os.path.join(REPO, "examples"))
        jax_run(controller="oracle", seconds=0.2, record=trace_path, verbose=False)
    trace = dict(np.load(trace_path))
    assert trace["obs_pos"].shape == (200, 3)
    port_gif = viz.animate_trot(trace, aliengo(device="cpu"), str(tmp_path / "port.gif"),
                                stride=10)
    jax_gif = jviz.animate_trot(trace, jaliengo(), str(tmp_path / "jax.gif"), stride=10)
    assert _frames(port_gif) == _frames(jax_gif) == 20


def test_visualize_example_writes_every_artifact(tmp_path):
    """The entry point end to end, in a process of its own: MuJoCo picks its
    GL backend once, when first imported in a process, and the offscreen
    GIF needs EGL, which another test's earlier import may not have set."""
    env = dict(os.environ, PYTHONPATH=REPO, MUJOCO_GL="egl", OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "pympc_quadruped_tpu_torch.examples.visualize", "--device", "cpu",
         "--seconds", "0.2", "--out", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    for name in ("trace.npz", "trot.gif", "trot_rendered.gif", "gait.png", "rollout.png",
                 "predicted_com.png"):
        assert os.path.getsize(tmp_path / name) > 2000, name
    assert _frames(tmp_path / "trot_rendered.gif") == 7       # 200 ticks, every 33rd
