"""The rest of tests/test_mujoco_e2e.py's gates on the port's controller
(CPU, the same bands): pacing10 and bounding8, jumping16 at h=16, the live
trot -> jump -> trot gait plan; and a lockstep of the port's MuJoCo loop
against the JAX example's.

Lockstep: both controllers start from the same MuJoCo state and each
drives its own simulation for 100 ticks.  The f32 condensed QP at h=10
stops at slightly different points in the two frameworks (ROADMAP watch
list: 0.4-0.7 N tick by tick), and each difference feeds back through the
plant.  Measured on this lockstep: forces within 0.42 N (of ~120 N),
torques within 0.14 N m, base position within 3e-5 m over the 100 ticks.
Bars: 1.0 N, 0.5 N m and 1e-3 m.
"""
import os
import sys

import numpy as np
import pytest
import torch

from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCKSTEP_TICKS = 100
LOCKSTEP_BARS = {"forces": 1.0, "torques": 0.5, "obs_pos": 1e-3}


@pytest.mark.parametrize("gait,vx,min_vx", [("pacing10", 0.8, 0.6), ("bounding8", 0.6, 0.45)])
def test_aliengo_nontrot_gaits_e2e(gait, vx, min_vx):
    res = run(gait=gait, vx=vx, seconds=2.5, verbose=False, device="cpu")
    assert res["completed"], res
    assert 0.33 < res["mean_height_last_2s"] < 0.45, res
    assert res["mean_vx_last_2s"] > min_vx, res


def test_jumping16_e2e():
    """JUMPING16 at h=16 survives in MuJoCo on the flight-aware reference."""
    res = run(gait="jumping16", horizon=16, vx=0.3, seconds=2.5, verbose=False, device="cpu")
    assert res["completed"], res
    assert 0.22 < res["mean_height_last_2s"] < 0.40, res
    assert res["final_x"] > 0.3, res


def test_trot_jump_trot_gait_plan():
    """Live gait switching at h=16: the controller carry crosses each switch."""
    res = run(horizon=16, vx=0.4, seconds=3.0, verbose=False, device="cpu",
              gait_plan=[("trotting16", 800), ("jumping16", 2100), ("trotting16", None)])
    assert res["completed"], res
    assert 0.25 < res["mean_height_last_2s"] < 0.42, res
    assert res["final_x"] > 0.5, res


def test_gait_plan_rejects_a_truncated_table():
    with pytest.raises(ValueError, match="truncated"):
        run(horizon=10, seconds=0.01, verbose=False, device="cpu",
            gait_plan=[("trotting10", 100), ("jumping16", None)])


def test_lockstep_with_the_jax_example(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        from mujoco_closed_loop import run as jax_run
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
    seconds = LOCKSTEP_TICKS / 1000
    jax_run(controller="jax", seconds=seconds, record=str(tmp_path / "jax.npz"), verbose=False)
    run(seconds=seconds, record=str(tmp_path / "port.npz"), verbose=False, device="cpu")
    ref, port = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(port.files) == sorted(ref.files)
    for key, bar in LOCKSTEP_BARS.items():
        assert port[key].shape == ref[key].shape == (LOCKSTEP_TICKS,) + ref[key].shape[1:]
        err = float(np.abs(port[key] - ref[key]).max())
        assert err < bar, (key, err)
