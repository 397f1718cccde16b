"""The full-order MuJoCo gates of tests/test_mujoco_e2e.py, driven by the
port's controller (``pympc_quadruped_tpu_torch/examples/mujoco_closed_loop.py``,
``controller.step_batch`` at B=1 with the default ``admm_fast``) on the CPU,
with the same bands: the Aliengo and A1 trots, the turning trot and both
raw-sensor runs through the Kalman filter.  The other gaits, the gait plan
and the lockstep against the JAX example are in
tests/test_torch_mujoco_e2e_gaits.py.
"""
import pytest
import torch

from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import run

torch.set_num_threads(1)


def test_aliengo_trot_e2e():
    """2 s Aliengo TROTTING10 @ 1.2 m/s on the generated model."""
    res = run(seconds=2.0, verbose=False, device="cpu")
    assert res["completed"], res
    assert abs(res["mean_height_last_2s"] - 0.38) < 0.02, res
    assert res["mean_vx_last_2s"] > 0.8, res
    assert res["final_x"] > 1.2, res


def test_a1_trot_e2e():
    """2 s A1 trot @ 1.4 m/s (A1's 0.42 m height target is beyond its reach,
    so it rides lower)."""
    res = run(robot="a1", seconds=2.0, verbose=False, device="cpu")
    assert res["completed"], res
    assert 0.3 < res["mean_height_last_2s"] < 0.43, res
    assert res["mean_vx_last_2s"] > 0.7, res


def test_aliengo_turning_trot():
    """The yaw-rate command turns the robot left along a curved path."""
    res = run(vx=0.6, yaw_rate=0.5, seconds=3.0, verbose=False, device="cpu")
    assert res["completed"], res
    assert res["final_yaw"] > 0.5, res
    assert res["final_y"] > 0.2, res
    assert abs(res["mean_height_last_2s"] - 0.38) < 0.02, res


@pytest.mark.parametrize("robot", ["aliengo", "a1"])
def test_trot_kf_raw_sensors(robot):
    """The trot driven by IMU and encoders through the two-stage filter,
    with no ground-truth state."""
    res = run(robot=robot, sensors="raw", seconds=2.0, verbose=False, device="cpu")
    assert res["completed"], res
    if robot == "aliengo":
        assert abs(res["mean_height_last_2s"] - 0.38) < 0.025, res
        assert res["mean_vx_last_2s"] > 0.7, res
    else:
        assert 0.3 < res["mean_height_last_2s"] < 0.43, res
