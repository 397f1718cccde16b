"""Build the port's dataclasses from the JAX package's values.

The JAX package's parameters and carries, given as numpy arrays keyed by
field name (nested dicts for nested dataclasses), become the port's
dataclasses on a given device (the card unless the caller passes
``device="cpu"``).  No JAX import: the caller does the
``np.asarray`` on the JAX side (:func:`as_arrays` does it for any
dataclass), so both frameworks compute from the same numbers.

Static fields (``MpcParams.horizon`` and friends) come back as Python
ints/bools; every other leaf keeps its dtype (float32, int32, bool).
The nested carries have functions of their own: ``ControllerCarry``, and the
rollouts' estimator-mode full carries, ``(controller_carry, kf_state,
held_forces)`` of ``srb_env`` and ``(controller_carry, kf_state, vworld,
f_feet)`` of ``fullorder``.  The solver configs (``NamedTuple``s of Python
numbers) come from the JAX config's ``_asdict()``: :func:`admm_config`
and :func:`ipm_config`.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pympc_quadruped_tpu_torch.control.controller import ControllerCarry
from pympc_quadruped_tpu_torch.control.refmpc import MpcCarry
from pympc_quadruped_tpu_torch.control.swing import SwingCarry
from pympc_quadruped_tpu_torch.env.fullorder import ContactParams, FullOrderState
from pympc_quadruped_tpu_torch.env.srb_env import SensorNoise, SrbState
from pympc_quadruped_tpu_torch.env.terrain import Terrain
from pympc_quadruped_tpu_torch.estimation.kf import KfParams, KfState
from pympc_quadruped_tpu_torch.models.command import Command
from pympc_quadruped_tpu_torch.models.gaits import GaitParams
from pympc_quadruped_tpu_torch.models.mpc import MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops.kin import RobotObs
from pympc_quadruped_tpu_torch.ops.qp.admm import AdmmConfig
from pympc_quadruped_tpu_torch.ops.qp.ipm import IpmConfig
from pympc_quadruped_tpu_torch.ops.rbd import RbdModel

# Fields that are static Python values in both packages.
_STATIC = {"horizon": int, "iterations_between_mpc": int,
           "ground_adaptive_height": bool}


def as_arrays(obj) -> dict:
    """Nested dict of numpy arrays from any dataclass whose leaves support
    ``np.asarray`` (a flax struct of JAX arrays, or a port dataclass of CPU
    tensors)."""
    return {
        f.name: (as_arrays(v) if dataclasses.is_dataclass(v) else np.asarray(v))
        for f in dataclasses.fields(obj)
        for v in [getattr(obj, f.name)]
    }


def _build(cls, arrays: dict, device="cuda"):
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = arrays[f.name]
        if f.name in _STATIC:
            kwargs[f.name] = _STATIC[f.name](v)
        else:
            kwargs[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return cls(**kwargs)


robot_params = functools.partial(_build, RobotParams)
mpc_params = functools.partial(_build, MpcParams)
gait_params = functools.partial(_build, GaitParams)
command = functools.partial(_build, Command)
mpc_carry = functools.partial(_build, MpcCarry)
swing_carry = functools.partial(_build, SwingCarry)
srb_state = functools.partial(_build, SrbState)
robot_obs = functools.partial(_build, RobotObs)
terrain = functools.partial(_build, Terrain)
kf_params = functools.partial(_build, KfParams)
kf_state = functools.partial(_build, KfState)
sensor_noise = functools.partial(_build, SensorNoise)
full_order_state = functools.partial(_build, FullOrderState)
rbd_model = functools.partial(_build, RbdModel)
contact_params = functools.partial(_build, ContactParams)


def controller_carry(arrays: dict, device="cuda") -> ControllerCarry:
    return ControllerCarry(
        mpc=mpc_carry(arrays["mpc"], device),
        swing=swing_carry(arrays["swing"], device),
    )


def full_carry(arrays, device="cuda"):
    """A rollout's full carry from the JAX one: a ``ControllerCarry`` (truth
    mode), or in estimator mode a tuple of (dict, dict, array...):
    ``(controller_carry, kf_state, held_forces)`` (``srb_env``) or
    ``(controller_carry, kf_state, vworld, f_feet)`` (``fullorder``)."""
    if isinstance(arrays, dict):
        return controller_carry(arrays, device)
    c, k, *rest = arrays
    return (controller_carry(c, device), kf_state(k, device),
            *(torch.from_numpy(np.array(a, copy=True)).to(device) for a in rest))


def admm_config(values: dict) -> AdmmConfig:
    """The plain ADMM's config from the JAX ``AdmmConfig._asdict()``."""
    return AdmmConfig(**values)


def ipm_config(values: dict) -> IpmConfig:
    """The IPM's config from the JAX ``IpmConfig._asdict()``."""
    return IpmConfig(**values)
