"""``examples/batch_viz.py``'s recorder in the port, on the CPU.

``record_batch`` runs one ``fullorder.RolloutLoop`` for the whole run and
copies (pos, quat, q) to the host every ``frame_ticks`` ticks.  Its frames
must be bit for bit those of the JAX example's loop of ``rollout`` calls, a
chunk a frame, run by the port, and those of one monolithic
``fullorder.rollout`` (its final state and its per-tick heights): chunked ==
monolithic.

Against the JAX example's ``record_batch`` on the same 9 scenarios, each
framework integrates its own f32 closed loop, and the condensed QP's
rounding differences feed back through the plant.  Measured over the 400
ticks: base position within 4.2e-4 m, quaternion within 1.4e-3, joint
angles within 9.0e-3 rad.  Bars: 2e-3 m, 5e-3 and 3e-2 rad.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from pympc_quadruped_tpu_torch.env import fullorder
from pympc_quadruped_tpu_torch.examples import batch_viz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SECONDS, FRAME_TICKS = 9, 0.4, 40
TICKS = int(SECONDS * 1000)
JAX_BARS = (2e-3, 5e-3, 3e-2)


def _frames():
    return batch_viz.record_batch(N, SECONDS, FRAME_TICKS, device="cpu", return_metrics=True)


def _assert_frame_equal(frame, state):
    for got, want in zip(frame, (state.pos, state.quat, state.q)):
        np.testing.assert_array_equal(got, want.numpy())


def test_record_batch_is_the_chunked_and_the_monolithic_rollout():
    frames, metrics = _frames()
    assert len(frames) == TICKS // FRAME_TICKS
    assert all(tuple(v.shape) == (TICKS, N) for v in metrics.values())
    args = batch_viz.batch_inputs(N, 0.6, "cpu")

    # The JAX example's loop: a rollout call a frame, resumed from the last.
    state = carry = None
    for frame, t0 in zip(frames, range(0, TICKS, FRAME_TICKS)):
        (state, carry), _ = fullorder.rollout(*args, FRAME_TICKS, state0=state, carry0=carry,
                                              tick0=t0)
        _assert_frame_equal(frame, state)

    (state, _), mono = fullorder.rollout(*args, TICKS)
    _assert_frame_equal(frames[-1], state)
    for key, v in mono.items():
        assert torch.equal(v, metrics[key]), key
    heights = np.stack([f[0][:, 2] for f in frames])
    np.testing.assert_array_equal(heights, mono["height"][FRAME_TICKS - 1::FRAME_TICKS].numpy())


def test_record_batch_matches_the_jax_example():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import batch_viz as jbv
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
    frames_j = jbv.record_batch(N, SECONDS, FRAME_TICKS)
    frames, _ = _frames()
    assert len(frames) == len(frames_j)
    for frame, frame_j in zip(frames, frames_j):
        for got, want, bar in zip(frame, frame_j, JAX_BARS):
            assert got.shape == np.shape(want)
            assert float(np.abs(got - np.asarray(want)).max()) < bar
    _, _, gait, cmd = batch_viz.batch_inputs(N, 0.6, "cpu")
    np.testing.assert_array_equal(gait.stance_offsets[:3].numpy(),
                                  [[0, 5, 5, 0], [5, 0, 5, 0], [4, 4, 0, 0]])
    np.testing.assert_array_equal(cmd.vel_base_des[::3, 0].numpy(),
                                  np.float32([0.36, 0.48, 0.6]))


def test_render_grid_writes_a_frame_per_snapshot(tmp_path):
    """The entry point (record, then render the grid) in a process of its
    own, where MuJoCo's first import picks EGL for the offscreen GIF."""
    from PIL import Image

    out = str(tmp_path / "grid.gif")
    env = dict(os.environ, PYTHONPATH=REPO, MUJOCO_GL="egl", OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "pympc_quadruped_tpu_torch.examples.batch_viz", "--device", "cpu",
         "--n", "4", "--seconds", "0.08", "--out", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with Image.open(out) as im:
        assert im.n_frames == 2
