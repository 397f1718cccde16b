"""The port's ``env/fullorder.py`` against the JAX package.

- ``contact_forces``, ``physics_step`` (flat and on terrain),
  ``default_init_state``, ``init_state_on_terrain``, ``observe`` and
  ``_diverged`` on seeded random inputs, at 1e-5 on positions and forces,
  1e-4 on velocities after a step (the step's 18x18 solve, accelerations
  of ~1e3, times dt);
- ``rollout`` in tick lockstep with JAX's: B=4 scenarios jittered as
  tests/test_rbd.py:35-65 does (scenario 0 nominal), Aliengo, 60 ticks (3
  solves), every per-tick metric and the final state and held forces, in
  the two configurations of chip_smoke.py phase 11: ``riccati`` at h=16
  (TROTTING16, 1.0 m/s; also with ``substeps=2``, and on stairs with
  ``ground_adaptive_height``) and ``admm_fast`` at h=10 (TROTTING10, 1.2
  m/s).  Tolerances: tests/test_torch_rollout.py's ``TOL`` /
  ``TOL_ADMM_FAST`` by quantity (``height`` as base position, ``vel_err``
  as base velocity, ``upright`` as the quaternion), plus the joint angles
  ``q`` and generalized velocities ``u`` at about five times the largest
  gap measured in this test's JAX setting (riccati: q 4.5e-6, u 1.7e-4,
  on stairs u 1.8e-3; admm_fast: q 3.7e-3, u 0.10, where the f32 condensed solves of the two
  frameworks hold forces ~0.5 N apart and the swing legs' torques carry
  that into the joint rates; at h=16 the forces drift 1.6 N apart, beyond
  ``TOL_ADMM_FAST``);
- ``init_full_carry`` (estimator mode, on terrain) against the carry JAX's
  ``rollout`` builds, through ``convert.full_carry``; ``ContactParams``
  and ``convert.contact_params``;
- the estimator rollout with ``SensorNoise.zero`` in lockstep with JAX's,
  at ``TOL`` but for the estimate and the held forces (``TOL_EST``);
- the port alone: two 60-tick chunks bitwise one 120-tick run (truth and
  estimator mode, tests/test_env_aux.py:169-199), the NaN-poisoned
  auto-reset (tests/test_rbd.py:288-313) and the 1500-tick trot band of
  tests/test_rbd.py:400-425.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.control import controller as jctrl
from pympc_quadruped_tpu.env import fullorder as jfo
from pympc_quadruped_tpu.env import mjcf as jmjcf
from pympc_quadruped_tpu.env import srb_env as jenv
from pympc_quadruped_tpu.env import terrain as jterrain
from pympc_quadruped_tpu.estimation import kf as jkf
from pympc_quadruped_tpu.models.command import Command as JCommand
from pympc_quadruped_tpu.models.gaits import Gaits as JGaits
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import a1 as ja1
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.ops import lie as jlie
from test_rbd import _jittered_init

from pympc_quadruped_tpu_torch import convert, tree
from pympc_quadruped_tpu_torch.env import fullorder, srb_env
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params

torch.set_num_threads(1)
A = convert.as_arrays
B, N_TICKS = 4, 60
TOL = {"contact_forces": 1e-2, "pos": 1e-5, "quat": 1e-5, "vel": 1e-4, "q": 2e-5, "u": 5e-3}
TOL_ADMM_FAST = {"contact_forces": 1.5, "pos": 1e-4, "quat": 3e-4, "vel": 4e-3, "q": 2e-2,
                 "u": 0.5}
# The estimator's run: its accelerometer is the difference of two ticks'
# velocities over 1 ms, so the filter sees the physics' gaps 1e3 times over
# (measured: est_pos_err 3.2e-5 m, held forces 1.1e-2 N).
TOL_EST = dict(TOL, contact_forces=5e-2, est_pos=1e-4)
METRIC_TOL = {"height": "pos", "vel_err": "vel", "upright": "quat", "est_pos_err": "est_pos",
              "est_vel_err": "vel"}


def _jtile(t, b=B):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + jnp.shape(x)), t)


def _port_model(model_j, b):
    """The port's model from JAX's unbatched one, tiled over ``b``."""
    arrays = {k: np.asarray(v) for k, v in model_j._asdict().items()}
    return tree.tile(convert.rbd_model(arrays, device="cpu"), b)


def _random_states(rng, b):
    """(pos, quat, u, q) of ``b`` random states near the stance."""
    pos = np.concatenate([rng.normal(scale=0.1, size=(b, 2)),
                          0.36 + rng.uniform(-0.03, 0.03, (b, 1))], axis=1)
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(scale=0.05, size=(b, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    u = rng.normal(scale=0.3, size=(b, 18))
    q = np.tile([0.0, 0.8, -1.6], 4) + rng.uniform(-0.3, 0.3, (b, 12))
    f = lambda a: a.astype(np.float32)
    return f(pos), f(quat), f(u), f(q)


def _states(rng, b):
    pos, quat, u, q = _random_states(rng, b)
    s_j = jfo.FullOrderState(pos=jnp.asarray(pos), quat=jnp.asarray(quat), u=jnp.asarray(u),
                             q=jnp.asarray(q))
    return s_j, convert.full_order_state(A(s_j), device="cpu")


def _assert_states(s, s_j, tol, msg=""):
    for name in ("pos", "quat", "u", "q"):
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(s_j, name)),
                                   atol=tol[name], err_msg=f"{msg} {name}")


def test_contact_params_default_matches_jax():
    cp_j, cp = jfo.ContactParams(), fullorder.ContactParams.default("cpu")
    converted = convert.contact_params(A(cp_j), device="cpu")
    for f in dataclasses.fields(cp):
        assert float(getattr(cp, f.name)) == float(getattr(cp_j, f.name)), f.name
        assert torch.equal(getattr(converted, f.name), getattr(cp, f.name)), f.name
    _, cp_a1 = fullorder.a1_env_config("cpu")
    assert float(cp_a1.tau_max) == float(jfo.a1_env_config()[1].tau_max)


@pytest.mark.parametrize("config", ["a1_env_config", "a1_isaacgym_parity_config"])
def test_a1_configs_match_jax(config):
    robot_j, cp_j = getattr(jfo, config)()
    robot, cp = getattr(fullorder, config)("cpu")
    for f in dataclasses.fields(robot):
        np.testing.assert_array_equal(getattr(robot, f.name).numpy(),
                                      np.asarray(getattr(robot_j, f.name)), err_msg=f.name)
    for f in dataclasses.fields(cp):
        assert float(getattr(cp, f.name)) == float(getattr(cp_j, f.name)), f.name


def test_contact_forces_matches_jax():
    """Random feet around the ground, half of them in contact, sliding fast
    enough that the friction cone clamps some; per-foot ground heights."""
    rng = np.random.default_rng(1)
    p = rng.normal(scale=0.3, size=(6, 4, 3)).astype(np.float32)
    p[..., 2] = rng.uniform(-0.02, 0.06, (6, 4))
    v = rng.normal(scale=0.5, size=(6, 4, 3)).astype(np.float32)
    gz = rng.uniform(-0.01, 0.01, (6, 4)).astype(np.float32)
    cp_j = jfo.ContactParams()
    cp = fullorder.ContactParams.default("cpu")
    want = jax.vmap(jfo.contact_forces, in_axes=(None, 0, 0, 0))(
        cp_j, jnp.asarray(p), jnp.asarray(v), jnp.asarray(gz))
    got = fullorder.contact_forces(cp, torch.tensor(p), torch.tensor(v), torch.tensor(gz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-6)
    assert float((got[..., 2] > 0).float().mean()) > 0.2
    flat_j = jax.vmap(jfo.contact_forces, in_axes=(None, 0, 0))(cp_j, jnp.asarray(p),
                                                                 jnp.asarray(v))
    flat = fullorder.contact_forces(cp, torch.tensor(p), torch.tensor(v))
    np.testing.assert_allclose(flat.numpy(), np.asarray(flat_j), atol=1e-3, rtol=1e-6)


@pytest.mark.parametrize("robot_name", ["aliengo", "a1"])
def test_init_states_match_jax(robot_name):
    robot_j = jaliengo() if robot_name == "aliengo" else ja1()
    robot = convert.robot_params(A(_jtile(robot_j, 2)), device="cpu")
    s_j = jfo.default_init_state(robot_j)
    s = fullorder.default_init_state(robot)
    for f in dataclasses.fields(s):
        np.testing.assert_array_equal(getattr(s, f.name)[1].numpy(),
                                      np.asarray(getattr(s_j, f.name)), err_msg=f.name)
    t_j = jterrain.slope(0.2, size=8.0, cell=0.1)
    t = convert.terrain(A(_jtile(t_j, 2)), device="cpu")
    s_j = jfo.init_state_on_terrain(robot_j, t_j, jnp.float32(0.03))
    s = fullorder.init_state_on_terrain(robot, t, torch.tensor(0.03))
    for f in dataclasses.fields(s):
        np.testing.assert_allclose(getattr(s, f.name)[0].numpy(),
                                   np.asarray(getattr(s_j, f.name)), atol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("terrain_name", ["flat", "stairs"])
def test_physics_step_matches_jax(terrain_name):
    """One step from random states under random torques, some feet in
    contact; the next state and the contact forces."""
    b = 5
    robot_j = jaliengo()
    model_j = jfo.rbd_model(robot_j, jmjcf.aliengo_spec())
    cp_j = jfo.ContactParams()
    rng = np.random.default_rng(2)
    s_j, s = _states(rng, b)
    tau = (rng.normal(size=(b, 12)) * 8.0).astype(np.float32)
    t_j = None if terrain_name == "flat" else jterrain.stairs(0.3, 0.02, size=4.0)
    dt = jnp.float32(0.001)
    step = (lambda m, st, ta: jfo.physics_step(m, robot_j, cp_j, st, ta, dt)) if t_j is None \
        else (lambda m, st, ta: jfo.physics_step(m, robot_j, cp_j, st, ta, dt, t_j))
    s2_j, f_j = jax.vmap(step, in_axes=(None, 0, 0))(model_j, s_j, jnp.asarray(tau))
    robot = convert.robot_params(A(_jtile(robot_j, b)), device="cpu")
    t = None if t_j is None else convert.terrain(A(_jtile(t_j, b)), device="cpu")
    s2, f = fullorder.physics_step(_port_model(model_j, b), robot,
                                   fullorder.ContactParams.default("cpu"), s,
                                   torch.tensor(tau), torch.tensor(0.001), t)
    assert float((f[..., 2] > 0).float().mean()) > 0.1, "no foot in contact"
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), atol=1e-3, rtol=1e-5)
    _assert_states(s2, s2_j, {"pos": 1e-5, "quat": 1e-5, "u": 1e-4, "q": 1e-5})


def test_observe_and_diverged_match_jax():
    rng = np.random.default_rng(4)
    s_j, s = _states(rng, 6)
    robot_j = jaliengo()
    robot = convert.robot_params(A(_jtile(robot_j, 6)), device="cpu")
    o_j = jax.vmap(jfo.observe, in_axes=(None, 0))(robot_j, s_j)
    o = fullorder.observe(robot, s)
    for f in dataclasses.fields(o):
        np.testing.assert_allclose(getattr(o, f.name).numpy(), np.asarray(getattr(o_j, f.name)),
                                   atol=1e-6, err_msg=f.name)
    # Scenario 1 non-finite, 2 too low, 3 too fast, 4 too high over its ground.
    pos, quat, u, q = (np.array(getattr(s_j, k)) for k in ("pos", "quat", "u", "q"))
    q[1, 4] = np.nan
    pos[2, 2] = 0.05
    u[3, 3] = 11.0
    ground = np.zeros(6, np.float32)
    ground[4] = -0.8
    bad_j = jfo._diverged(jfo.FullOrderState(pos=jnp.asarray(pos), quat=jnp.asarray(quat),
                                             u=jnp.asarray(u), q=jnp.asarray(q)),
                          jnp.asarray(ground))
    bad = fullorder._diverged(fullorder.FullOrderState(*map(torch.tensor, (pos, quat, u, q))),
                              torch.tensor(ground))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(bad_j))
    assert bad.tolist() == [False, True, True, True, True, False]


def _rollout_setup(h=16, vx=1.0, terrain_name="flat", adaptive=False, b=B, seed=13):
    mpc_j = JMpcParams(horizon=h, ground_adaptive_height=adaptive)
    robot_j = _jtile(jaliengo(), b)
    gait_j = _jtile(JGaits.trotting16() if h == 16 else JGaits.trotting10(), b)
    cmd_j = _jtile(JCommand.trot_forward(vx), b)
    terr_j = None if terrain_name == "flat" else _jtile(jterrain.stairs(0.30, 0.04), b)
    state_j = _jittered_init(robot_j, b, seed=seed, terrain=terr_j)
    jx = dict(robot_b=robot_j, mpc=mpc_j, gait_b=gait_j, cmd_b=cmd_j, state0=state_j,
              terrain=terr_j)
    pt = dict(robot_b=convert.robot_params(A(robot_j), device="cpu"),
              mpc=convert.mpc_params(A(mpc_j), device="cpu"),
              gait_b=convert.gait_params(A(gait_j), device="cpu"),
              cmd_b=convert.command(A(cmd_j), device="cpu"),
              state0=convert.full_order_state(A(state_j), device="cpu"),
              terrain=None if terr_j is None else convert.terrain(A(terr_j), device="cpu"))
    return jx, pt


def _assert_lockstep(got, want, tol):
    (s, c), m = got
    (s_j, c_j), m_j = want
    assert set(m) == set(m_j)
    for name, v in m.items():
        assert tuple(v.shape) == (N_TICKS, B)
        if name == "diverged":
            assert not v.any() and not np.asarray(m_j[name]).any()
            continue
        np.testing.assert_allclose(v.numpy(), np.asarray(m_j[name]), atol=tol[METRIC_TOL[name]],
                                   err_msg=name)
    _assert_states(s, s_j, tol)
    np.testing.assert_allclose(c.mpc.contact_forces.numpy(), np.asarray(c_j.mpc.contact_forces),
                               atol=tol["contact_forces"])


@pytest.mark.parametrize("solver,terrain_name,substeps", [
    ("riccati", "flat", 1),
    ("admm_fast", "flat", 1),
    ("riccati", "flat", 2),
    ("riccati", "stairs", 1),
])
def test_rollout_lockstep_matches_jax(solver, terrain_name, substeps):
    """Truth-mode rollout: every tick's metrics, the final state and forces."""
    tol = TOL if solver == "riccati" else TOL_ADMM_FAST
    h, vx = (16, 1.0) if solver == "riccati" else (10, 1.2)
    jx, pt = _rollout_setup(h=h, vx=vx, terrain_name=terrain_name,
                            adaptive=terrain_name != "flat")
    want = jax.jit(lambda: jfo.rollout(num_ticks=N_TICKS, solver=solver, substeps=substeps,
                                       **jx))()
    got = fullorder.rollout(num_ticks=N_TICKS, solver=solver, substeps=substeps, **pt)
    _assert_lockstep(got, want, tol)


def test_estimator_rollout_zero_noise_matches_jax():
    """The filter on zero-noise sensors with measured-contact gating, from
    the same jittered states (the two noise generators then play no part)."""
    jx, pt = _rollout_setup()
    est_j = jkf.KfParams.default().replace(contact_height=jnp.float32(0.0255))
    est = convert.kf_params(A(est_j), device="cpu")
    want = jax.jit(lambda: jfo.rollout(num_ticks=N_TICKS, solver="riccati", estimator=est_j,
                                       sensor_noise=jenv.SensorNoise.zero(), **jx))()
    got = fullorder.rollout(num_ticks=N_TICKS, solver="riccati", estimator=est,
                            sensor_noise=srb_env.SensorNoise.zero("cpu"), **pt)
    assert {"est_pos_err", "est_vel_err"} <= set(got[1])
    _assert_lockstep(got, want, TOL_EST)


def test_init_full_carry_matches_jax():
    """The estimator-mode full carry at the jittered states on stairs: the
    filter, world velocity and contact forces JAX's ``rollout`` builds
    before its scan (env/fullorder.py:455-476), converted with
    ``convert.full_carry``, against the port's ``init_full_carry``."""
    jx, pt = _rollout_setup(terrain_name="stairs")
    robot_j, s0_j, terr_j = jx["robot_b"], jx["state0"], jx["terrain"]
    cp_j = jfo.ContactParams()
    c0_j = jax.vmap(lambda _: jctrl.init_carry(16))(jnp.arange(B))
    feet0, vfeet0, _ = jax.vmap(jfo.foot_kinematics)(robot_j, s0_j)
    kf0 = jax.vmap(lambda s, f: jkf.KfState.init(s.pos, f))(s0_j, feet0)
    vworld0 = jnp.einsum("bij,bj->bi", jax.vmap(jlie.quat_to_rotmat)(s0_j.quat), s0_j.u[:, 3:6])
    gz0 = jax.vmap(lambda t, p: jterrain.height_at(t, p[:, :2]))(terr_j, feet0)
    f0 = jax.vmap(jfo.contact_forces, in_axes=(None, 0, 0, 0))(cp_j, feet0, vfeet0, gz0)
    want = convert.full_carry((A(c0_j), A(kf0), np.asarray(vworld0), np.asarray(f0)),
                              device="cpu")
    got = fullorder.init_full_carry(pt["robot_b"], pt["mpc"], pt["state0"],
                                    fullorder.ContactParams.default("cpu"),
                                    estimator=kf.KfParams.default(device="cpu"),
                                    terrain=pt["terrain"])
    assert len(got) == len(want) == 4
    tree.tree_map(lambda x, y: np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5),
                  got, want)


def _small_batch(b, vx, h=10):
    d = "cpu"
    return (default_mpc_params(h, device=d), tree.tile(aliengo(d), b),
            tree.tile(Gaits.trotting10(d), b), tree.tile(Command.trot_forward(vx, d), b))


def _assert_trees_equal(a, b):
    tree.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)


@pytest.mark.parametrize("mode", ["truth", "estimator"])
def test_chunked_rollout_equals_monolithic_bitwise(mode):
    """2 x 60 ticks (state0, carry0, tick0) == 120 ticks, bit for bit
    (tests/test_env_aux.py:169-199); in estimator mode with sensor noise,
    resumed from the full carry."""
    mpc, robot, gait, cmd = _small_batch(2, 0.8)
    kw = dict(solver="riccati", return_full_carry=True)
    if mode == "estimator":
        kw.update(estimator=kf.KfParams.default(device="cpu"), key=5, substeps=2)
    (s_m, c_m), m_m = fullorder.rollout(robot, mpc, gait, cmd, 120, **kw)
    (s_1, c_1), m_1 = fullorder.rollout(robot, mpc, gait, cmd, 60, **kw)
    (s_2, c_2), m_2 = fullorder.rollout(robot, mpc, gait, cmd, 60, state0=s_1, carry0=c_1,
                                        tick0=60, **kw)
    _assert_trees_equal((s_m, c_m), (s_2, c_2))
    for k in m_m:
        _assert_trees_equal(m_m[k], torch.cat([m_1[k], m_2[k]]))
    assert isinstance(c_m, tuple) == (mode == "estimator")
    if mode == "estimator":
        assert float(m_m["est_pos_err"].max()) > 0.0


def test_rollout_auto_reset_recovers_poisoned_scenario():
    """tests/test_rbd.py:288-313: a NaN velocity in scenario 1 is flagged and
    reset every tick (its mass matrix solve gives NaN, as JAX's does), while
    scenario 0 trots on untouched."""
    mpc, robot, gait, cmd = _small_batch(2, 1.2)
    state0 = fullorder.default_init_state(robot)
    state0.u[1, 3] = float("nan")
    (state, _), metrics = fullorder.rollout(robot, mpc, gait, cmd, 1500, state0=state0,
                                            auto_reset=True)
    div, up = metrics["diverged"], metrics["upright"]
    assert not bool(div[:, 0].any()), "well-posed scenario must not reset"
    assert bool(div[:, 1].any()), "poisoned scenario should be flagged"
    assert bool(torch.isfinite(state.pos).all())
    assert float(up[-300:, 0].min()) > 0.9, "well-posed scenario degraded by neighbor"


def test_fullorder_closed_loop_trot_band():
    """tests/test_rbd.py:400-425 on the port: B=5 jittered (seed 27), h=10,
    TROTTING10, 1.2 m/s, the default solver, 1500 ticks; at least 4 of 5
    hold the band over the last 500 ticks."""
    b = 5
    jx, pt = _rollout_setup(h=10, vx=1.2, b=b, seed=27)
    (state, _), m = fullorder.rollout(num_ticks=1500, **pt)
    h = m["height"][-500:].mean(dim=0)
    v = m["vel_err"][-500:].mean(dim=0)
    up = m["upright"][-500:].amin(dim=0)
    finite = torch.isfinite(m["height"]).all(dim=0)
    ok = finite & (h > 0.33) & (h < 0.42) & (v < 0.15) & (up > 0.9) & (state.pos[:, 0] > 1.0)
    assert int(ok.sum()) >= b - 1, f"only {int(ok.sum())} of {b} in the band: {ok}"
