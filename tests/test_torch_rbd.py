"""The port's ``ops/rbd.py``, ``fullorder.rbd_model`` and ``env/mjcf.py`` specs
against the JAX package and MuJoCo 3.10.

- the inertial specs and ``rbd_model`` for Aliengo and A1: equal to JAX's;
- ``mass_matrix``, ``bias_forces`` (with and without foot forces),
  ``forward_dynamics``, ``u_from_mujoco`` and ``qacc_to_mujoco`` on
  tests/test_rbd.py:93-102's random states, batched, against JAX's per
  state: within 1e-5 of (1 + |JAX's value|), and the accelerations (after
  two f32 Cholesky factorizations that round differently) within 5e-5
  (measured on a CPU: H 2.3e-8, C 8.6e-7, du 5.3e-6 of that scale);
- the port's ``qacc`` against MuJoCo's on the model the JAX package
  generates (tests/test_rbd.py:104-176's check and bar, 1e-4 relative);
- H symmetric positive definite;
- a failed Cholesky: the scenario's accelerations are NaN, as JAX's are,
  and the batch's other scenarios are untouched.
"""
import dataclasses

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import mujoco
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.env import fullorder as jfo
from pympc_quadruped_tpu.env import mjcf as jmjcf
from pympc_quadruped_tpu.ops import kin as jkin
from pympc_quadruped_tpu.ops import lie as jlie
from pympc_quadruped_tpu.ops import rbd as jrbd
from test_rbd import _random_state, _setup

from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.env import fullorder, mjcf
from pympc_quadruped_tpu_torch.models import a1, aliengo
from pympc_quadruped_tpu_torch.ops import lie, rbd

torch.set_num_threads(1)
N_STATES = 4
REL, REL_ACC = 1e-5, 5e-5


def _port_robot(name, b=1):
    return tree.tile(aliengo("cpu") if name == "aliengo" else a1("cpu"), b)


def _port_spec(name):
    return mjcf.aliengo_spec() if name == "aliengo" else mjcf.a1_spec()


def _port_model(name, b):
    return fullorder.rbd_model(_port_robot(name, b), _port_spec(name))


def _states(seed, n=N_STATES):
    """n of tests/test_rbd.py's random states, stacked, with random foot
    forces: (q, quat, qvel, tau, f_feet) float32 arrays."""
    rng = np.random.default_rng(seed)
    rows = [_random_state(rng) for _ in range(n)]
    q12, quat, v_world, w_body, qd, tau = (np.stack(c) for c in zip(*rows))
    qvel = np.concatenate([v_world, w_body, qd], axis=1)
    f_feet = rng.normal(size=(n, 4, 3)) * 30.0
    f32 = lambda a: a.astype(np.float32)
    return f32(q12), f32(quat), f32(qvel), f32(tau), f32(f_feet)


def _close(got, want, rel=REL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / (1.0 + np.abs(want)))
    assert err < rel, f"{msg}: {err:.2e} of (1 + |ref|) (bar {rel:.0e})"


@pytest.mark.parametrize("name", ["aliengo", "a1"])
def test_specs_and_model_match_jax(name):
    spec_j = getattr(jmjcf, f"{name}_spec")()
    spec = _port_spec(name)
    assert dataclasses.asdict(spec) == dataclasses.asdict(spec_j)
    robot_j = _setup(name)[0]
    model_j = jfo.rbd_model(robot_j, spec_j)
    model = _port_model(name, 3)
    for key, want in model_j._asdict().items():
        got = getattr(model, key)
        assert tuple(got.shape) == (3,) + tuple(jnp.shape(want)), key
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want), err_msg=key)


@pytest.mark.parametrize("name", ["aliengo", "a1"])
def test_dynamics_match_jax(name):
    """Every public function of ops/rbd on a batch of random states against
    JAX's on each state."""
    robot_j, model_j = _setup(name)[:2]
    model = _port_model(name, N_STATES)
    q12, quat, qvel, tau, f_feet = _states(seed=0)
    R = lie.quat_to_rotmat(torch.tensor(quat))
    u = rbd.u_from_mujoco(torch.tensor(qvel), R)
    zero_f = torch.zeros(N_STATES, 4, 3)
    H = rbd.mass_matrix(model, torch.tensor(q12))
    C0 = rbd.bias_forces(model, torch.tensor(q12), u, R, zero_f)
    C = rbd.bias_forces(model, torch.tensor(q12), u, R, torch.tensor(f_feet))
    du = rbd.forward_dynamics(model, torch.tensor(q12), u, R, torch.tensor(tau),
                              torch.tensor(f_feet))
    qacc = rbd.qacc_to_mujoco(du, u, R)
    for i in range(N_STATES):
        R_j = jnp.asarray(R[i].numpy())
        q_j = jnp.asarray(q12[i])
        u_j = jrbd.u_from_mujoco(jnp.asarray(qvel[i]), R_j)
        _close(u[i], u_j, msg="u_from_mujoco")
        _close(H[i], jrbd.mass_matrix(model_j, q_j), msg="mass_matrix")
        _close(C0[i], jrbd.bias_forces(model_j, q_j, u_j, R_j, jnp.zeros((4, 3))),
               msg="bias_forces")
        _close(C[i], jrbd.bias_forces(model_j, q_j, u_j, R_j, jnp.asarray(f_feet[i])),
               msg="bias_forces with foot forces")
        du_j = jrbd.forward_dynamics(model_j, q_j, u_j, R_j, jnp.asarray(tau[i]),
                                     jnp.asarray(f_feet[i]))
        _close(du[i], du_j, REL_ACC, msg="forward_dynamics")
        _close(qacc[i], jrbd.qacc_to_mujoco(du_j, u_j, R_j), REL_ACC, msg="qacc_to_mujoco")


@pytest.mark.parametrize("name,forces", [("aliengo", False), ("a1", False),
                                         ("aliengo", True)])
def test_qacc_matches_mujoco(name, forces):
    """The port's forward dynamics == MuJoCo's qacc on the generated model
    (mid-air: gravity, velocity products, armature, damping, actuation, and
    with ``forces`` point forces at the feet applied by mj_applyFT)."""
    robot_j, _, m, d, calf_ids = _setup(name)
    model = _port_model(name, N_STATES)
    q12, quat, qvel, tau, f_feet = _states(seed=7 if forces else 0)
    if not forces:
        f_feet = np.zeros_like(f_feet)
    R = lie.quat_to_rotmat(torch.tensor(quat))
    u = rbd.u_from_mujoco(torch.tensor(qvel), R)
    du = rbd.forward_dynamics(model, torch.tensor(q12), u, R, torch.tensor(tau),
                              torch.tensor(f_feet))
    qacc = rbd.qacc_to_mujoco(du, u, R).numpy().astype(np.float64)
    for i in range(N_STATES):
        d.qpos[:3] = [0, 0, 5.0]
        d.qpos[3:7] = quat[i]
        d.qpos[7:] = q12[i]
        d.qvel[:] = qvel[i]
        d.ctrl[:] = tau[i]
        d.qfrc_applied[:] = 0
        mujoco.mj_forward(m, d)
        if forces:
            R64 = np.asarray(jlie.quat_to_rotmat(jnp.asarray(quat[i])), np.float64)
            p_bf, _ = jkin.leg_forward_kinematics(robot_j, jnp.asarray(q12[i].reshape(4, 3)))
            p_world = np.array([0, 0, 5.0]) + np.asarray(p_bf, np.float64) @ R64.T
            for leg in range(4):
                mujoco.mj_applyFT(m, d, f_feet[i, leg].astype(np.float64), np.zeros(3),
                                  p_world[leg], calf_ids[leg], d.qfrc_applied)
            mujoco.mj_forward(m, d)
        rel = np.max(np.abs(qacc[i] - d.qacc) / (1.0 + np.abs(d.qacc)))
        assert rel < 1e-4, f"{name} state {i}: qacc mismatch rel {rel:.2e}"


def test_mass_matrix_symmetric_positive_definite():
    model = _port_model("aliengo", 8)
    rng = np.random.default_rng(3)
    q = rng.uniform(-0.6, 0.6, (8, 12)) + np.tile([0.0, 0.8, -1.6], 4)
    H = rbd.mass_matrix(model, torch.tensor(q, dtype=torch.float32)).double()
    torch.testing.assert_close(H, H.transpose(-1, -2), rtol=0, atol=1e-5)
    assert float(torch.linalg.eigvalsh(H).min()) > 0.0


def test_failed_cholesky_gives_nan_rows():
    """A matrix that is not positive definite: JAX's ``cholesky`` +
    ``cho_solve`` gives NaN, and so does the port, for that scenario only;
    likewise a NaN state in ``forward_dynamics``."""
    rng = np.random.default_rng(5)
    M = rng.normal(size=(3, 18, 18)).astype(np.float32)
    H = M @ M.transpose(0, 2, 1) + 18.0 * np.eye(18, dtype=np.float32)
    H[1] = H[1] - 200.0 * np.eye(18, dtype=np.float32)         # indefinite
    rhs = rng.normal(size=(3, 18)).astype(np.float32)
    x = rbd.spd_solve(torch.tensor(H), torch.tensor(rhs)).numpy()
    for i in range(3):
        x_j = np.asarray(jsl.cho_solve((jnp.linalg.cholesky(jnp.asarray(H[i])), True),
                                       jnp.asarray(rhs[i])))
        assert np.isnan(x[i]).all() == np.isnan(x_j).all()
        if i != 1:
            np.testing.assert_allclose(x[i], x_j, rtol=1e-4, atol=1e-6)
    assert np.isnan(x[1]).all() and np.isfinite(x[[0, 2]]).all()

    model = _port_model("aliengo", N_STATES)
    q12, quat, qvel, tau, f_feet = map(torch.tensor, _states(seed=9))
    R = lie.quat_to_rotmat(quat)
    u = rbd.u_from_mujoco(qvel, R)
    du = rbd.forward_dynamics(model, q12, u, R, tau, f_feet)
    q_bad = q12.clone()
    q_bad[2, 4] = float("nan")
    du_bad = rbd.forward_dynamics(model, q_bad, u, R, tau, f_feet)
    assert bool(torch.isnan(du_bad[2]).all())
    keep = [0, 1, 3]
    torch.testing.assert_close(du_bad[keep], du[keep], rtol=0, atol=0)
