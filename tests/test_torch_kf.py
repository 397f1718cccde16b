"""The port's Kalman filter, sensors and estimator-mode rollout against JAX.

- ``kf.update`` and ``orientation_update``: B=3 filters driven 100 ticks by
  the same seeded random sensor stream in both frameworks, held to the
  tolerances of tests/test_kf.py:216-218 (quaternion 2e-5, state 5e-4,
  covariance 1e-4);
- ``synthesize_sensors`` with ``SensorNoise.zero()``: the readings are
  then the truth, compared with JAX's at 1e-5;
- the estimator-mode ``rollout`` with zero noise in tick lockstep with
  JAX's, in both ``contact_source`` modes (B=2, A1 and Aliengo, h=10,
  TROTTING10, 60 ticks, ``riccati``), with the per-quantity tolerances of
  tests/test_torch_controller.py;
- with noise, the port alone: the bands of tests/test_kf.py:280-287 and
  :311-319 (the generators differ, so the noise values cannot match).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.env import srb_env as jenv
from pympc_quadruped_tpu.estimation import kf as jkf
from pympc_quadruped_tpu.models.command import Command as JCommand
from pympc_quadruped_tpu.models.gaits import Gaits as JGaits
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import a1 as ja1
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo

from pympc_quadruped_tpu_torch import convert, tree
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.models import Command, Gaits, a1, aliengo, default_mpc_params

torch.set_num_threads(1)
A = convert.as_arrays


def _jtile(t, b):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + jnp.shape(x)), t)


def test_kf_update_matches_jax():
    B = 3
    robot_j = jaliengo()
    prm_j = jkf.KfParams.default()
    feet = np.array([[0.24, 0.13, 0.0], [0.24, -0.13, 0.0],
                     [-0.24, 0.13, 0.0], [-0.24, -0.13, 0.0]], np.float32)
    pos0 = np.array([[0.0, 0.0, 0.38], [0.1, -0.05, 0.4], [0.0, 0.02, 0.36]], np.float32)
    state_j = jax.vmap(lambda p: jkf.KfState.init(p, jnp.asarray(feet)))(jnp.asarray(pos0))
    state = kf.KfState.init(torch.tensor(pos0), torch.tensor(feet).expand(B, 4, 3))
    for f in ("quat", "x", "P"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(state_j, f)))
    robot = convert.robot_params(A(_jtile(robot_j, B)), device="cpu")
    prm = convert.kf_params(A(prm_j), device="cpu")
    upd = jax.jit(jax.vmap(lambda s, gy, ac, qj, qd, c: jkf.update(
        s, robot_j, gy, ac, qj, qd, c, prm_j)))
    orient = jax.vmap(lambda s, gy, ac: jkf.orientation_update(s, gy, ac, prm_j))
    rng = np.random.default_rng(7)
    q0 = np.tile([0.0, 0.8, -1.6], 4)
    for t in range(100):
        gyro = (0.3 * rng.normal(size=(B, 3))).astype(np.float32)
        accel = (np.array([0.0, 0.0, 9.81]) + 0.5 * rng.normal(size=(B, 3))).astype(np.float32)
        qj = (q0 + 0.1 * rng.normal(size=(B, 12))).astype(np.float32)
        qdj = (0.5 * rng.normal(size=(B, 12))).astype(np.float32)
        contact = (rng.uniform(size=(B, 4)) > 0.4).astype(np.float32)
        if t % 25 == 0:
            q_j = orient(state_j, jnp.asarray(gyro), jnp.asarray(accel))
            q_p = kf.orientation_update(state, torch.tensor(gyro), torch.tensor(accel), prm)
            np.testing.assert_allclose(q_p.numpy(), np.asarray(q_j), atol=2e-5)
        state_j = upd(state_j, *map(jnp.asarray, (gyro, accel, qj, qdj, contact)))
        state = kf.update(state, robot, *map(torch.tensor, (gyro, accel, qj, qdj, contact)), prm)
    np.testing.assert_allclose(state.quat.numpy(), np.asarray(state_j.quat), atol=2e-5)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(state_j.x), atol=5e-4)
    np.testing.assert_allclose(state.P.numpy(), np.asarray(state_j.P), atol=1e-4)
    obs = kf.to_obs(state, torch.tensor(gyro), torch.tensor(qj), torch.tensor(qdj))
    np.testing.assert_array_equal(obs.pos_base.numpy(), state.x[:, :3].numpy())
    np.testing.assert_array_equal(obs.lin_vel_base.numpy(), state.x[:, 3:6].numpy())


def test_synthesize_sensors_zero_noise_matches_jax():
    B = 2
    robot_j = _jtile(jaliengo(), B)
    s_j = jax.vmap(jenv.default_init_state)(robot_j)
    rng = np.random.default_rng(3)
    s_j = s_j.replace(
        quat=jnp.asarray(np.array([[1.0, 0.0, 0.0, 0.0], [0.99, 0.05, -0.08, 0.1]], np.float32)
                         / np.array([[1.0], [np.linalg.norm([0.99, 0.05, -0.08, 0.1])]],
                                    np.float32)),
        vel=jnp.asarray(rng.normal(scale=0.3, size=(B, 3)).astype(np.float32)),
        omega_body=jnp.asarray(rng.normal(scale=0.3, size=(B, 3)).astype(np.float32)),
        foot_vel=jnp.asarray(rng.normal(scale=0.2, size=(B, 4, 3)).astype(np.float32)))
    forces = rng.uniform(0.0, 40.0, (B, 12)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    want = jax.vmap(lambda r, s, f, k: jenv.synthesize_sensors(
        r, s, f, k, jenv.SensorNoise.zero()))(robot_j, s_j, jnp.asarray(forces), keys)
    got = srb_env.synthesize_sensors(
        convert.robot_params(A(robot_j), device="cpu"), convert.srb_state(A(s_j), device="cpu"),
        torch.tensor(forces), torch.Generator().manual_seed(0), srb_env.SensorNoise.zero("cpu"))
    for f in ("quat", "gyro", "accel", "q", "qdot"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-5, err_msg=f)
    noisy = srb_env.synthesize_sensors(
        convert.robot_params(A(robot_j), device="cpu"), convert.srb_state(A(s_j), device="cpu"),
        torch.tensor(forces), torch.Generator().manual_seed(0), srb_env.SensorNoise.default("cpu"))
    assert float((noisy.gyro - got.gyro).abs().max()) > 0.0


# tests/test_torch_controller.py's riccati tolerances.
TOL = {"pos": 1e-5, "quat": 1e-5, "vel": 1e-4, "omega_body": 1e-4, "foot_pos": 1e-5}
METRIC_TOL = {"height": 1e-5, "vel_err": 1e-4, "upright": 1e-5, "est_pos_err": 1e-5,
              "est_vel_err": 1e-4, "contact_mismatch": 0.0}


@pytest.mark.parametrize("robot_name,contact_source", [
    ("aliengo", "plan"), ("a1", "measured"),
])
def test_estimator_rollout_zero_noise_matches_jax(robot_name, contact_source):
    B, N = 2, 60
    jrobot = {"aliengo": jaliengo, "a1": ja1}[robot_name]
    robot_j, gait_j = _jtile(jrobot(), B), _jtile(JGaits.trotting10(), B)
    cmd_j, mpc_j = _jtile(JCommand.trot_forward(1.0), B), JMpcParams(horizon=10)
    (s_j, c_j), m_j = jax.jit(lambda: jenv.rollout(
        robot_j, mpc_j, gait_j, cmd_j, N, solver="riccati", estimator=jkf.KfParams.default(),
        sensor_noise=jenv.SensorNoise.zero(), key=jax.random.PRNGKey(1),
        contact_source=contact_source, return_full_carry=True))()
    (s, c), m = srb_env.rollout(
        convert.robot_params(A(robot_j), device="cpu"),
        convert.mpc_params(A(mpc_j), device="cpu"),
        convert.gait_params(A(gait_j), device="cpu"), convert.command(A(cmd_j), device="cpu"),
        N, solver="riccati", estimator=kf.KfParams.default(device="cpu"),
        sensor_noise=srb_env.SensorNoise.zero("cpu"), key=1, contact_source=contact_source,
        return_full_carry=True)
    assert set(m) == set(m_j)
    for name, v in m.items():
        if name == "diverged":
            assert not v.any() and not np.asarray(m_j[name]).any()
            continue
        np.testing.assert_allclose(v.numpy(), np.asarray(m_j[name]), atol=METRIC_TOL[name],
                                   err_msg=name)
    for name, tol in TOL.items():
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(s_j, name)),
                                   atol=tol, err_msg=name)
    c_ref = convert.full_carry((A(c_j[0]), A(c_j[1]), np.asarray(c_j[2])), device="cpu")
    np.testing.assert_allclose(c[1].x.numpy(), c_ref[1].x.numpy(), atol=1e-4)
    np.testing.assert_allclose(c[2].numpy(), c_ref[2].numpy(), atol=1e-2)
    if contact_source == "measured":
        assert float(m["contact_mismatch"].max()) > 0.0


def _port_batch(robot_fn, vx, B=2):
    d = "cpu"
    return (tree.tile(robot_fn(d), B), default_mpc_params(10, device=d),
            tree.tile(Gaits.trotting10(d), B), tree.tile(Command.trot_forward(vx, d), B))


@pytest.mark.parametrize("robot_fn,vx", [(aliengo, 1.2), (a1, 1.0)])
def test_trot_closed_loop_on_kf_estimates_with_noise(robot_fn, vx):
    """The bands of tests/test_kf.py:280-287, on the port with its own noise."""
    robot, mpc, gait, cmd = _port_batch(robot_fn, vx)
    (state, _), m = srb_env.rollout(robot, mpc, gait, cmd, num_ticks=600,
                                    estimator=kf.KfParams.default(device="cpu"), key=11,
                                    auto_reset=False)
    assert not bool(m["diverged"].any()), "rollout diverged"
    h_des = float(robot_fn("cpu").base_height_des)
    h_last = float(m["height"][-200:].mean())
    assert abs(h_last - h_des) < 0.05, f"height {h_last:.3f} vs {h_des}"
    assert float(m["est_pos_err"][-200:].mean()) < 0.1
    assert float(m["est_vel_err"][-200:].mean()) < 0.25


def test_measured_contact_gating_with_noise():
    """The bands of tests/test_kf.py:311-319: the measured gate disagrees
    with the plan transiently, and the filter stays bounded."""
    robot, mpc, gait, cmd = _port_batch(aliengo, 1.0)
    (state, _), m = srb_env.rollout(robot, mpc, gait, cmd, num_ticks=600,
                                    estimator=kf.KfParams.default(device="cpu"), key=13,
                                    auto_reset=False, contact_source="measured")
    mm = m["contact_mismatch"].numpy()
    assert not bool(m["diverged"].any()), "rollout diverged"
    assert mm.max() > 0.0, "measured and planned gating never disagreed"
    assert (mm > 0).mean() > 0.01, "disagreement not transiently recurring"
    assert mm.mean() < 0.3, f"gates disagree {mm.mean():.0%} of leg-ticks"
    assert float(m["est_pos_err"][-200:].mean()) < 0.15
    assert float(m["est_vel_err"][-200:].mean()) < 0.25
