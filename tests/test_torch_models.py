"""The port's parameters equal the JAX package's, field by field.

Each JAX object goes through ``np.asarray`` and ``convert.py`` into the
port's dataclass, which must equal the port's own constructor exactly
(same dtype, same bits): the parameters are data, so no tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.models import command as jcommand
from pympc_quadruped_tpu.models import gaits as jgaits
from pympc_quadruped_tpu.models import mpc as jmpc
from pympc_quadruped_tpu.models import robots as jrobots
from pympc_quadruped_tpu.ops.qp import riccati as jriccati

from pympc_quadruped_tpu_torch import convert, tree
from pympc_quadruped_tpu_torch.models import command, gaits, mpc, robots
from pympc_quadruped_tpu_torch.ops.qp import riccati

torch.set_num_threads(1)

GAITS = ["standing", "trotting16", "trotting10", "jumping16", "pacing16",
         "pacing10", "bounding8"]


def _assert_same(port_obj, converted):
    assert type(port_obj) is type(converted)
    for f in dataclasses.fields(port_obj):
        a, b = getattr(port_obj, f.name), getattr(converted, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            assert a.shape == b.shape, f.name
            assert torch.equal(a, b), (f.name, a, b)
        else:
            assert type(a) is type(b) and a == b, f.name


@pytest.mark.parametrize("name", ["aliengo", "a1"])
def test_robot_params_equal(name):
    jax_obj = getattr(jrobots, name)()
    _assert_same(getattr(robots, name)(device="cpu"),
                 convert.robot_params(convert.as_arrays(jax_obj), device="cpu"))


def test_a1_inertia_quirk():
    """A1's trunk inertia is the URDF value times 10 (ref robot_configs.py:50)."""
    np.testing.assert_allclose(robots.a1(device="cpu").inertia[0, 0].item(), 0.1683993, rtol=1e-6)


@pytest.mark.parametrize("name", GAITS)
def test_gaits_equal(name):
    jax_obj = jgaits.Gaits.by_name(name)
    port = gaits.Gaits.by_name(name, device="cpu")
    _assert_same(port, convert.gait_params(convert.as_arrays(jax_obj), device="cpu"))
    assert int(port.total_stance_segments) == int(jax_obj.total_stance_segments)
    assert int(port.total_swing_segments) == int(jax_obj.total_swing_segments)


@pytest.mark.parametrize("horizon", [10, 16])
def test_mpc_params_equal(horizon):
    jax_obj = jmpc.MpcParams(horizon=horizon)
    port = mpc.MpcParams(horizon=horizon)
    _assert_same(port, convert.mpc_params(convert.as_arrays(jax_obj), device="cpu"))
    assert port.dt_predict.item() == np.float32(0.05)      # the reference's dt quirk
    assert port.dt_gait.item() == np.float32(np.asarray(jax_obj.dt_gait))
    assert (mpc.NUM_STATE, mpc.NUM_INPUT) == (jmpc.NUM_STATE, jmpc.NUM_INPUT)


def test_command_equal():
    jax_obj = jcommand.Command.trot_forward(1.2)
    _assert_same(command.Command.trot_forward(1.2, device="cpu"),
                 convert.command(convert.as_arrays(jax_obj), device="cpu"))


def test_mass_norm_ref_is_aliengo_mass():
    """The port derives MASS_NORM_REF from its own aliengo() (the JAX
    package repeats 9.042 by hand), and it equals the JAX constant in f32."""
    assert riccati.MASS_NORM_REF == robots.aliengo(device="cpu").mass.item()
    assert np.float32(riccati.MASS_NORM_REF) == np.float32(jriccati.MASS_NORM_REF)


def test_riccati_config_presets_match():
    for name in ("iterations", "rho", "sigma", "alpha", "pin", "normalize"):
        assert getattr(riccati.RiccatiConfig(), name) == getattr(jriccati.RiccatiConfig(), name)
        assert (getattr(riccati.RiccatiConfig.inloop(), name)
                == getattr(jriccati.RiccatiConfig.inloop(), name))


def test_tree_tile_and_to():
    r = tree.tile(robots.aliengo(device="cpu"), 3)
    assert r.mass.shape == (3,) and r.hip_offset.shape == (3, 4, 3)
    assert torch.equal(r.hip_offset[2], robots.aliengo(device="cpu").hip_offset)
    m = tree.to(mpc.MpcParams(horizon=7), "cpu")
    assert m.horizon == 7 and m.q_diag.device.type == "cpu"
