"""The MJCF generator of ``env/mjcf.py``: the port against the JAX package.

The port reads its own ``RobotParams`` (float32 tensors) as Python floats
and formats them as the JAX generator does (``%.6g`` of the same float32
values), so the XML is compared as text, character for character.  The
generated model then compiles in MuJoCo, and its feet in the nominal stance
sit where the port's closed-form leg FK puts them (1e-6 m).
"""
import mujoco
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.env import mjcf as jmjcf

from pympc_quadruped_tpu_torch.env import mjcf
from pympc_quadruped_tpu_torch.models import a1, aliengo
from pympc_quadruped_tpu_torch.ops import kin

torch.set_num_threads(1)

NOMINAL_Q = (0.0, 0.8, -1.6)


@pytest.mark.parametrize("name", ["aliengo", "a1"])
def test_model_xml_is_the_jax_text(name):
    assert mjcf.model_xml(name) == jmjcf.model_xml(name)


@pytest.mark.parametrize("name,n,spacing", [("aliengo", 9, 1.2), ("a1", 5, 0.9)])
def test_grid_model_xml_is_the_jax_text(name, n, spacing):
    assert mjcf.grid_model_xml(name, n, spacing) == jmjcf.grid_model_xml(name, n, spacing)


def test_write_model(tmp_path):
    path = mjcf.write_model(str(tmp_path / "a1.xml"), "a1")
    with open(path) as f:
        assert f.read() == jmjcf.model_xml("a1")


@pytest.mark.parametrize("name,robot_fn", [("aliengo", aliengo), ("a1", a1)])
def test_nominal_stance_feet_match_the_port_fk(name, robot_fn):
    model = mujoco.MjModel.from_xml_string(mjcf.model_xml(name))
    assert (model.nu, model.nsensordata) == (12, 38)
    data = mujoco.MjData(model)
    data.qpos[:3] = [0.0, 0.0, 0.38]
    data.qpos[3:7] = [1.0, 0.0, 0.0, 0.0]
    data.qpos[7:] = np.tile(NOMINAL_Q, 4)
    mujoco.mj_forward(model, data)
    feet = np.stack([data.site_xpos[model.site(f"{n}_tc").id] for n in ("fl", "fr", "rl", "rr")])
    robot = robot_fn(device="cpu")
    p_bf, _ = kin.leg_forward_kinematics(robot, torch.tensor([NOMINAL_Q] * 4))
    np.testing.assert_allclose(feet, p_bf.double().numpy() + [0.0, 0.0, 0.38], atol=1e-6)


def test_grid_model_compiles_with_one_free_body_per_instance():
    model = mujoco.MjModel.from_xml_string(mjcf.grid_model_xml("aliengo", 9))
    assert (model.nq, model.nu, model.nsensor) == (9 * 19, 0, 0)
