"""The MuJoCo example's float64 golden controller in the port
(``run(controller="oracle")``, :mod:`pympc_quadruped_tpu_torch.oracle.npref`)
on the CPU: tests/test_mujoco_e2e.py:29-48's Aliengo and A1 trot bands, and
a 100-tick lockstep against the JAX example's ``--controller oracle`` on
the same generated MuJoCo model.

Lockstep: each example drives its own simulation from the same state.
Both controllers are float64 with the same arithmetic, so they part only
by rounding (the QP solutions ~1e-10 apart, fed back through the plant):
forces and torques are held within 1e-6 of (1 + |x|).
"""
import os
import sys

import numpy as np
import pytest
import torch

from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCKSTEP_TICKS, LOCKSTEP_BAR = 100, 1e-6


def test_aliengo_trot_e2e_oracle():
    """2 s Aliengo TROTTING10 @ 1.2 m/s on the generated model."""
    res = run(controller="oracle", seconds=2.0, verbose=False, device="cpu")
    assert res["completed"], res
    assert abs(res["mean_height_last_2s"] - 0.38) < 0.02, res
    assert res["mean_vx_last_2s"] > 0.8, res
    assert res["final_x"] > 1.2, res


def test_a1_trot_e2e_oracle():
    """2 s A1 trot @ 1.4 m/s (A1's 0.42 m height target is beyond its reach,
    so it rides lower)."""
    res = run(controller="oracle", robot="a1", seconds=2.0, verbose=False, device="cpu")
    assert res["completed"], res
    assert 0.3 < res["mean_height_last_2s"] < 0.43, res
    assert res["mean_vx_last_2s"] > 0.7, res


def test_oracle_refuses_a_gait_plan():
    with pytest.raises(ValueError, match="--controller torch"):
        run(controller="oracle", horizon=16, seconds=0.01, verbose=False, device="cpu",
            gait_plan=[("trotting16", 100), ("trotting16", None)])


def test_lockstep_with_the_jax_example_oracle(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        from mujoco_closed_loop import run as jax_run
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
    seconds = LOCKSTEP_TICKS / 1000
    jax_run(controller="oracle", seconds=seconds, record=str(tmp_path / "jax.npz"), verbose=False)
    run(controller="oracle", seconds=seconds, record=str(tmp_path / "port.npz"), verbose=False,
        device="cpu")
    ref, port = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(port.files) == sorted(ref.files)
    for key in ("forces", "torques"):
        assert port[key].shape == ref[key].shape == (LOCKSTEP_TICKS, 12)
        err = float(np.max(np.abs(port[key] - ref[key]) / (1.0 + np.abs(ref[key]))))
        assert err < LOCKSTEP_BAR, (key, err)
