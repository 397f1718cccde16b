"""The port's ``srb_env.rollout`` and ``env/terrain.py`` against the JAX package.

Lockstep: B=4 jittered scenarios (scenario 0 nominal), Aliengo, h=16,
TROTTING16 at 1.2 m/s, 60 ticks (3 solves), JAX ``rollout`` and the port's
``rollout`` from the same numbers, every per-tick metric compared, then the
final state and held forces.  The tolerances are those of
tests/test_torch_controller.py, by quantity: ``height`` as base position,
``vel_err`` as base velocity, ``upright`` (R[2,2]) as the quaternion.  On
terrain the controller runs with ``ground_adaptive_height``.

The rest: ``auto_reset`` on a NaN-poisoned scenario
(tests/test_env_aux.py:85-100, with ``admm_fast``), chunked runs bitwise
equal to one run, ``Command.ramped``, every terrain generator with
``height_at`` and ``normal_at`` (atol 1e-6 / 1e-5), the box smoothing on
JAX's raw uniform grid, and ``physics_step`` on terrain.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.env import srb_env as jenv
from pympc_quadruped_tpu.env import terrain as jterrain
from pympc_quadruped_tpu.models.command import Command as JCommand
from pympc_quadruped_tpu.models.gaits import Gaits as JGaits
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo

from pympc_quadruped_tpu_torch import convert, tree
from pympc_quadruped_tpu_torch.env import srb_env, terrain
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params

torch.set_num_threads(1)

B, H, N_TICKS = 4, 16, 60
# tests/test_torch_controller.py's tolerances.
TOL = {"contact_forces": 1e-2, "pos": 1e-5, "quat": 1e-5, "vel": 1e-4,
       "omega_body": 1e-4, "foot_pos": 1e-5}
TOL_ADMM_FAST = {"contact_forces": 1.5, "pos": 1e-4, "quat": 3e-4, "vel": 4e-3,
                 "omega_body": 1.5e-2, "foot_pos": 2e-4}
METRIC_TOL = {"height": "pos", "vel_err": "vel", "upright": "quat"}
A = convert.as_arrays


def _jtile(t, b=B):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + jnp.shape(x)), t)


def _jax_terrain(name):
    return {"flat": None, "slope": lambda: jterrain.slope(0.15),
            "stairs": lambda: jterrain.stairs(0.30, 0.06)}[name]


def _setup(terrain_name, adaptive):
    mpc_j = JMpcParams(horizon=H, ground_adaptive_height=adaptive)
    robot_j = _jtile(jaliengo())
    gait_j = _jtile(JGaits.trotting16())
    cmd_j = _jtile(JCommand.trot_forward(1.2))
    make = _jax_terrain(terrain_name)
    terr_j = None if make is None else _jtile(make())
    state_j = (jax.vmap(jenv.default_init_state)(robot_j) if terr_j is None
               else jax.vmap(jenv.init_state_on_terrain)(robot_j, terr_j))
    rng = np.random.default_rng(31)
    dpos = np.zeros((B, 3), np.float32)
    dpos[1:, :2] = rng.uniform(-0.01, 0.01, (B - 1, 2))
    dvel = np.zeros((B, 3), np.float32)
    dvel[1:] = rng.uniform(-0.02, 0.02, (B - 1, 3))
    state_j = state_j.replace(pos=state_j.pos + dpos, vel=state_j.vel + dvel)
    port = dict(
        robot=convert.robot_params(A(robot_j), device="cpu"),
        mpc=convert.mpc_params(A(mpc_j), device="cpu"),
        gait=convert.gait_params(A(gait_j), device="cpu"),
        cmd=convert.command(A(cmd_j), device="cpu"),
        init_state=convert.srb_state(A(state_j), device="cpu"),
        terrain=None if terr_j is None else convert.terrain(A(terr_j), device="cpu"),
    )
    jaxs = dict(robot=robot_j, mpc=mpc_j, gait=gait_j, cmd=cmd_j, init_state=state_j,
                terrain=terr_j)
    return jaxs, port


@pytest.mark.parametrize("solver,terrain_name,ramp", [
    ("riccati", "flat", None),
    ("admm_fast", "flat", None),
    ("riccati", "flat", 40),
    ("riccati", "slope", None),
    ("riccati", "stairs", None),
    ("admm_fast", "stairs", None),
])
def test_rollout_lockstep_matches_jax(solver, terrain_name, ramp):
    """Truth-mode rollout, every tick's metrics and the final state."""
    tol = TOL if solver == "riccati" else TOL_ADMM_FAST
    jx, pt = _setup(terrain_name, adaptive=terrain_name != "flat")
    (state_j, carry_j), m_j = jax.jit(lambda: jenv.rollout(
        jx["robot"], jx["mpc"], jx["gait"], jx["cmd"], N_TICKS, init_state=jx["init_state"],
        solver=solver, terrain=jx["terrain"], cmd_ramp_ticks=ramp))()
    (state, carry), m = srb_env.rollout(
        pt["robot"], pt["mpc"], pt["gait"], pt["cmd"], N_TICKS, init_state=pt["init_state"],
        solver=solver, terrain=pt["terrain"], cmd_ramp_ticks=ramp)
    assert set(m) == set(m_j)
    for name, v in m.items():
        assert tuple(v.shape) == (N_TICKS, B)
        if name == "diverged":
            assert not v.any() and not np.asarray(m_j[name]).any()
            continue
        np.testing.assert_allclose(v.numpy(), np.asarray(m_j[name]),
                                   atol=tol[METRIC_TOL[name]], err_msg=name)
    for name in ("pos", "quat", "vel", "omega_body", "foot_pos"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(state_j, name)), atol=tol[name],
                                   err_msg=name)
    np.testing.assert_allclose(carry.mpc.contact_forces.numpy(),
                               np.asarray(carry_j.mpc.contact_forces),
                               atol=tol["contact_forces"])


def _small_batch(b, vx, h=10):
    d = "cpu"
    return (default_mpc_params(h, device=d), tree.tile(aliengo(d), b),
            tree.tile(Gaits.trotting10(d), b), tree.tile(Command.trot_forward(vx, d), b))


def test_rollout_auto_reset_recovers_poisoned_scenario():
    """tests/test_env_aux.py:85-100 with the port's default solver: a NaN
    velocity in scenario 1 is flagged and reset, scenario 0 is untouched."""
    mpc, robot, gait, cmd = _small_batch(2, 0.5)
    init = srb_env.default_init_state(robot)
    init.vel[1, 0] = float("nan")
    (env_state, _), metrics = srb_env.rollout(robot, mpc, gait, cmd, num_ticks=40,
                                              init_state=init, solver="admm_fast")
    assert bool(metrics["diverged"][:, 1].any()), "divergence not flagged"
    assert not bool(metrics["diverged"][:, 0].any()), "healthy scenario flagged"
    assert bool(torch.isfinite(env_state.pos).all())


def _assert_trees_equal(a, b):
    tree.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)


@pytest.mark.parametrize("mode", ["truth", "estimator"])
def test_chunked_rollout_equals_monolithic_bitwise(mode):
    """2 x 50 ticks (tick0, carry_in, return_full_carry) == 100 ticks, bit
    for bit: gait phase and sensor noise are functions of the absolute tick."""
    mpc, robot, gait, cmd = _small_batch(3, 1.0)
    kw = dict(solver="riccati", cmd_ramp_ticks=30)
    if mode == "estimator":
        kw.update(estimator=kf.KfParams.default(device="cpu"), key=5,
                  contact_source="measured")
    (s_m, c_m), m_m = srb_env.rollout(robot, mpc, gait, cmd, 100, return_full_carry=True, **kw)
    (s_1, c_1), m_1 = srb_env.rollout(robot, mpc, gait, cmd, 50, return_full_carry=True, **kw)
    (s_2, c_2), m_2 = srb_env.rollout(robot, mpc, gait, cmd, 50, init_state=s_1,
                                      carry_in=c_1, tick0=50, return_full_carry=True, **kw)
    _assert_trees_equal((s_m, c_m), (s_2, c_2))
    for k in m_m:
        _assert_trees_equal(m_m[k], torch.cat([m_1[k], m_2[k]]))
    assert isinstance(c_m, tuple) == (mode == "estimator")


@pytest.mark.parametrize("ramp", [0, 0.5, 30, 300])
def test_command_ramped_matches_jax(ramp):
    cmd_j = JCommand.trot_forward(1.2).replace(yaw_turn_rate=jnp.float32(0.3))
    cmd = convert.command(A(cmd_j), device="cpu")
    for tick in (0, 1, 15, 29, 30, 299, 1000):
        want = cmd_j.ramped(jnp.int32(tick), ramp)
        for t in (tick, torch.tensor(tick, dtype=torch.int32)):
            got = cmd.ramped(t, ramp)
            np.testing.assert_allclose(got.vel_base_des.numpy(), np.asarray(want.vel_base_des),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(got.yaw_turn_rate.numpy(),
                                       np.asarray(want.yaw_turn_rate), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Terrain
# ---------------------------------------------------------------------------

GENERATORS = {
    "flat": (lambda m: m.flat(size=4.0, cell=0.1), {}),
    "slope_x": (lambda m: m.slope(0.2, size=8.0, cell=0.1, axis=0), {}),
    "slope_y": (lambda m: m.slope(0.15, axis=1), {}),
    "stairs": (lambda m: m.stairs(0.30, 0.06), {}),
    "stairs_y": (lambda m: m.stairs(0.3, 0.1, size=6.0, cell=0.05, axis=1), {}),
    "pyramid": (lambda m: m.pyramid(0.3, platform=1.0, size=10.0, cell=0.1), {}),
}


def _port_gen(make):
    class M:
        def __getattr__(self, name):
            fn = getattr(terrain, name)
            return lambda *a, **k: fn(*a, device="cpu", **k)
    return make(M())


@pytest.mark.parametrize("name", list(GENERATORS))
def test_terrain_generators_match_jax(name):
    make, _ = GENERATORS[name]
    t_j, t_p = make(jterrain), _port_gen(make)
    np.testing.assert_allclose(t_p.height.numpy(), np.asarray(t_j.height), atol=1e-6)
    np.testing.assert_allclose(t_p.cell.numpy(), np.asarray(t_j.cell), atol=0)
    np.testing.assert_allclose(t_p.origin.numpy(), np.asarray(t_j.origin), atol=0)
    ext_j, ext_p = t_j.extent, t_p.extent
    np.testing.assert_allclose([float(e) for e in ext_p], [float(e) for e in ext_j], rtol=1e-6)
    rng = np.random.default_rng(len(name))
    xy = rng.uniform(-6.0, 6.0, (7, 5, 2)).astype(np.float32)     # incl. off-grid
    np.testing.assert_allclose(terrain.height_at(t_p, torch.tensor(xy)).numpy(),
                               np.asarray(jterrain.height_at(t_j, jnp.asarray(xy))), atol=1e-6)
    np.testing.assert_allclose(terrain.normal_at(t_p, torch.tensor(xy)).numpy(),
                               np.asarray(jterrain.normal_at(t_j, jnp.asarray(xy))), atol=1e-5)


def test_height_at_per_scenario_grids_matches_jax():
    """A stack of different grids, one per scenario, queried at each
    scenario's four feet (the vmapped JAX query)."""
    grids_j = [jterrain.slope(0.1), jterrain.slope(-0.2, axis=1), jterrain.flat()]
    t_j = jax.tree.map(lambda *xs: jnp.stack(xs), *grids_j)
    t_p = convert.terrain(A(t_j), device="cpu")
    xy = np.random.default_rng(2).uniform(-3, 3, (3, 4, 2)).astype(np.float32)
    want = jax.vmap(jterrain.height_at)(t_j, jnp.asarray(xy))
    np.testing.assert_allclose(terrain.height_at(t_p, torch.tensor(xy)).numpy(),
                               np.asarray(want), atol=1e-6)


def test_random_rough_smoothing_on_jax_grid():
    """``smooth_heights`` on the raw uniform grid JAX draws inside
    ``random_rough`` gives JAX's terrain; the port's own draw is bounded
    and deterministic per seed."""
    key = jax.random.PRNGKey(4)
    amp, size, cell = 0.05, 4.0, 0.1
    n = int(round(size / cell)) + 1
    raw = np.asarray(jax.random.uniform(key, (n, n), minval=-amp, maxval=amp))
    t_j = jterrain.random_rough(key, amplitude=amp, size=size, cell=cell)
    for smooth in (0, 1, 2):
        got = terrain.smooth_heights(torch.tensor(raw), smooth)
        want = t_j.height if smooth == 2 else jterrain.random_rough(
            key, amplitude=amp, size=size, cell=cell, smooth=smooth).height
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    gen = lambda: torch.Generator().manual_seed(9)
    t1 = terrain.random_rough(gen(), amplitude=amp, size=size, cell=cell, device="cpu")
    t2 = terrain.random_rough(gen(), amplitude=amp, size=size, cell=cell, device="cpu")
    assert torch.equal(t1.height, t2.height)
    assert float(t1.height.abs().max()) <= amp + 1e-6
    assert tuple(t1.height.shape) == (n, n) and float(t1.height.std()) > 0.0


def test_init_and_physics_step_on_terrain_match_jax():
    """``init_state_on_terrain``, then ``physics_step`` with feet commanded
    0.5 m under a 0.3 slope and random forces: JAX's state, feet floored
    at the surface."""
    robot_j, mpc_j = jaliengo(), JMpcParams(horizon=10)
    t_j = jterrain.slope(grade=0.3, size=8.0, cell=0.1)
    s_j = jenv.init_state_on_terrain(robot_j, t_j)
    rng = np.random.default_rng(12)
    forces = rng.uniform(0, 60, 12).astype(np.float32)
    swing = np.array([0.0, 0.5, 0.0, 0.3], np.float32)
    target = np.asarray(s_j.foot_pos) + rng.normal(scale=0.05, size=(4, 3)).astype(np.float32)
    target[:, 2] -= 0.5
    s2_j = jenv.physics_step(robot_j, mpc_j, s_j, jnp.asarray(forces), jnp.asarray(swing),
                             jnp.asarray(target), t_j)

    robot = convert.robot_params(A(_jtile(robot_j, 1)), device="cpu")
    mpc = convert.mpc_params(A(mpc_j), device="cpu")
    t_p = convert.terrain(A(_jtile(t_j, 1)), device="cpu")
    s = srb_env.init_state_on_terrain(robot, t_p)
    for f in dataclasses.fields(s):
        np.testing.assert_allclose(getattr(s, f.name)[0].numpy(), np.asarray(getattr(s_j, f.name)),
                                   atol=1e-6, err_msg=f.name)
    s2 = srb_env.physics_step(robot, mpc, s, torch.tensor(forces)[None], torch.tensor(swing)[None],
                              torch.tensor(target)[None], t_p)
    for f in dataclasses.fields(s2):
        np.testing.assert_allclose(getattr(s2, f.name)[0].numpy(),
                                   np.asarray(getattr(s2_j, f.name)), atol=1e-5, err_msg=f.name)
    ground = terrain.height_at(t_p, s2.foot_pos[..., :2])
    assert bool((s2.foot_pos[..., 2] >= ground - 1e-5).all())
