"""The closed-loop tick: the port's ``loop.run_ticks`` in lockstep with the
JAX package's ``controller.step_batch`` + ``physics_step``, for both ported
solvers (``"riccati"`` and the default ``"admm_fast"``).

B=4 jittered scenarios (scenario 0 nominal), h=16, 60 ticks = 3 solve
ticks, compared after every tick.  Tolerances, from the two frameworks'
f32 rounding.  riccati: held forces 1e-2 N and torques 1e-2 N m (the 40
in-loop ADMM sweeps reassociate differently; measured ~1e-3 at ~100 N),
base position and orientation 1e-5, base velocity 1e-4 m/s.  admm_fast:
the condensed solve inverts a kappa ~ 1e5 matrix in f32, and the two
frameworks' matrix products round that inverse differently (~1e-4
relative, tests/test_torch_admm.py); a fixed 40-sweep solve then stops at
a different point along the QP's weak directions, at equal cost.  The
first, cold solve differs by 0.39 N (of ~90 N), and over the 3 solves
the measured spread is 0.73 N in held forces, 0.28 N m in torques,
3.6e-5 m in position, 1.2e-4 in the quaternion, 1.7e-3 m/s and
7.3e-3 rad/s in the velocities, 9.1e-5 m at the feet.  The tolerances
are about twice those.  Each parametrization jits the JAX tick once.  (No jumping16 lockstep: its flight tables make the QP
ill-conditioned, and the two frameworks' solves already differ by 0.1 N at
the first tick, which the rigid body integrates into 1e-3 rad/s within two
ticks; its flight-aware reference rows are compared on their own below.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.control import controller as jctrl
from pympc_quadruped_tpu.control import refmpc as jrefmpc
from pympc_quadruped_tpu.env import srb_env as jenv
from pympc_quadruped_tpu.models.command import Command as JCommand
from pympc_quadruped_tpu.models.gaits import Gaits as JGaits
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.ops import gaitsched as jgaitsched

from pympc_quadruped_tpu_torch import convert
from pympc_quadruped_tpu_torch.control import controller, refmpc
from pympc_quadruped_tpu_torch.loop import run_ticks

torch.set_num_threads(1)

B, H, N_TICKS = 4, 16, 60
TOL = {"contact_forces": 1e-2, "torques": 1e-2, "pos": 1e-5, "quat": 1e-5,
       "vel": 1e-4, "omega_body": 1e-4, "foot_pos": 1e-5}
TOL_ADMM_FAST = {"contact_forces": 1.5, "torques": 0.6, "pos": 1e-4, "quat": 3e-4,
                 "vel": 4e-3, "omega_body": 1.5e-2, "foot_pos": 2e-4}


def _jax_setup(adaptive):
    tile = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), t)
    mpc = JMpcParams(horizon=H, ground_adaptive_height=adaptive)
    robot = tile(jaliengo())
    gait = tile(JGaits.trotting16())
    cmd = tile(JCommand.trot_forward(1.2))
    state = jax.vmap(jenv.default_init_state)(robot)
    rng = np.random.default_rng(31)
    dpos = np.zeros((B, 3), np.float32)
    dpos[1:, :2] = rng.uniform(-0.01, 0.01, (B - 1, 2))
    dvel = np.zeros((B, 3), np.float32)
    dvel[1:] = rng.uniform(-0.02, 0.02, (B - 1, 3))
    state = state.replace(pos=state.pos + dpos, vel=state.vel + dvel)
    carry = jax.vmap(lambda _: jctrl.init_carry(H))(jnp.arange(B))
    return mpc, robot, gait, cmd, state, carry


# The riccati cases keep the ids they had when riccati was the only solver.
@pytest.mark.parametrize("solver,adaptive", [
    pytest.param("riccati", False, id="False"),
    pytest.param("riccati", True, id="True"),
    pytest.param("admm_fast", False, id="admm_fast-False"),
    pytest.param("admm_fast", True, id="admm_fast-True"),
])
def test_tick_lockstep_matches_jax(solver, adaptive):
    """TROTTING16 at 1.2 m/s, with both static ground_adaptive_height
    programs (reference rows, ground estimate and swing targets differ)."""
    tol = TOL if solver == "riccati" else TOL_ADMM_FAST
    mpc_j, robot_j, gait_j, cmd_j, state_j, carry_j = _jax_setup(adaptive)

    @jax.jit
    def jax_tick(state, carry, tick):
        obs = jax.vmap(jenv.observe)(robot_j, state)
        carry, out = jctrl.step_batch(robot_j, mpc_j, gait_j, cmd_j, carry, obs, tick,
                                      solver=solver)
        swing_pos_world = state.pos[:, None, :] + jnp.einsum(
            "bij,blj->bli", out.kin.R_base, out.pos_targets)
        state = jax.vmap(lambda r, s, f, ss, sp: jenv.physics_step(r, mpc_j, s, f, ss, sp))(
            robot_j, state, out.contact_forces, out.swing_states, swing_pos_world)
        return state, carry, out

    A = convert.as_arrays
    robot = convert.robot_params(A(robot_j), device="cpu")
    mpc = convert.mpc_params(A(mpc_j), device="cpu")
    gait = convert.gait_params(A(gait_j), device="cpu")
    cmd = convert.command(A(cmd_j), device="cpu")
    state = convert.srb_state(A(state_j), device="cpu")
    carry = convert.controller_carry(A(carry_j), device="cpu")
    assert mpc.ground_adaptive_height is adaptive

    for tick in range(N_TICKS):
        state_j, carry_j, out_j = jax_tick(state_j, carry_j, jnp.int32(tick))
        carry, state, out = run_ticks(robot, mpc, gait, cmd, carry, state, tick, 1, solver)
        for name in ("contact_forces", "torques"):
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(out_j, name)),
                                       atol=tol[name], err_msg=f"tick {tick} {name}")
        for name in ("pos", "quat", "vel", "omega_body", "foot_pos"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(state_j, name)),
                                       atol=tol[name], err_msg=f"tick {tick} {name}")
    if solver == "riccati":
        np.testing.assert_allclose(carry.mpc.qp_primal.numpy(),
                                   np.asarray(carry_j.mpc.qp_primal), atol=tol["contact_forces"])


@pytest.mark.parametrize("tick", [0, 40, 100, 180, 260])
def test_reference_trajectory_with_flight_matches_jax(tick):
    """X_ref rows incl. the flight-aware z/vz arcs of jumping16 (the
    lockstep's trot tables never take that branch) and the carry update."""
    rng = np.random.default_rng(tick)
    mpc_j = JMpcParams(horizon=H)
    robot_j = jaliengo()
    table = np.asarray(jgaitsched.gait_table(JGaits.jumping16(), mpc_j, jnp.int32(tick)))
    x_t = rng.normal(scale=0.3, size=(B, 13)).astype(np.float32)
    x_t[:, 12] = -9.81
    vel = rng.normal(size=(B, 3)).astype(np.float32)
    carry = jrefmpc.MpcCarry.init(H).replace(
        xpos_des=jnp.float32(0.05), pitch_comp_int=jnp.float32(0.1))
    cmd = JCommand.trot_forward(0.4)
    c_j, X_j = jax.vmap(lambda x, v: jrefmpc.reference_trajectory(
        carry, x, v, cmd, mpc_j, robot_j, jnp.asarray(table)))(x_t, vel)

    tile = lambda d: {k: np.broadcast_to(v, (B,) + v.shape) for k, v in d.items()}
    c_p, X_p = refmpc.reference_trajectory(
        convert.mpc_carry(tile(convert.as_arrays(carry)), device="cpu"),
        torch.tensor(x_t), torch.tensor(vel),
        convert.command(tile(convert.as_arrays(cmd)), device="cpu"),
        convert.mpc_params(convert.as_arrays(mpc_j), device="cpu"),
        convert.robot_params(tile(convert.as_arrays(robot_j)), device="cpu"),
        torch.tensor(table).expand(B, -1))
    np.testing.assert_allclose(X_p.numpy(), np.asarray(X_j), rtol=1e-5, atol=1e-5)
    for f in dataclasses.fields(c_p):
        np.testing.assert_allclose(getattr(c_p, f.name).numpy(), np.asarray(getattr(c_j, f.name)),
                                   rtol=1e-5, atol=1e-6)


def test_single_scenario_step_matches_jax():
    """``controller.step`` (batch of one under the hood) on a solve tick."""
    mpc_j, robot_j, gait_j, cmd_j, state_j, _ = _jax_setup(False)
    first = lambda t: jax.tree.map(lambda x: x[1], t)
    robot_j, gait_j, cmd_j, state_j = map(first, (robot_j, gait_j, cmd_j, state_j))
    obs_j = jenv.observe(robot_j, state_j)
    carry_j, out_j = jctrl.step(robot_j, mpc_j, gait_j, cmd_j, jctrl.init_carry(H), obs_j,
                                jnp.int32(0), solver="riccati")
    A = convert.as_arrays
    carry, out = controller.step(
        convert.robot_params(A(robot_j), device="cpu"), convert.mpc_params(A(mpc_j), device="cpu"),
        convert.gait_params(A(gait_j), device="cpu"), convert.command(A(cmd_j), device="cpu"),
        convert.controller_carry(A(jctrl.init_carry(H)), device="cpu"),
        convert.robot_obs(A(obs_j), device="cpu"),
        0, solver="riccati")
    assert out.torques.shape == (12,)
    np.testing.assert_allclose(out.contact_forces.numpy(), np.asarray(out_j.contact_forces),
                               atol=TOL["contact_forces"])
    np.testing.assert_allclose(out.torques.numpy(), np.asarray(out_j.torques),
                               atol=TOL["torques"])


def test_unknown_solver_raises():
    """Every solver name of the JAX controller is accepted; any other name
    raises ``ValueError``."""
    for solver in ("admm_fast", "riccati", "admm", "ipm", "ipm_parity"):
        controller.check_solver(solver)
    with pytest.raises(ValueError, match="unknown solver"):
        controller.check_solver("osqp")


def _nan_setup():
    """tests/test_fault_and_fast_loop.py's setup: B=2, h=10, TROTTING10 at
    0.6 m/s from the SRB nominal stance, in both frameworks."""
    Bn, h = 2, 10
    tile = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (Bn,) + jnp.shape(x)), t)
    mpc_j = JMpcParams(horizon=h)
    robot_j, gait_j = tile(jaliengo()), tile(JGaits.trotting10())
    cmd_j = tile(JCommand.trot_forward(0.6))
    obs_j = jax.vmap(jenv.observe)(robot_j, jax.vmap(jenv.default_init_state)(robot_j))
    carry_j = jax.vmap(lambda _: jctrl.init_carry(h))(jnp.arange(Bn))
    A = convert.as_arrays
    port = (convert.robot_params(A(robot_j), device="cpu"),
            convert.mpc_params(A(mpc_j), device="cpu"),
            convert.gait_params(A(gait_j), device="cpu"), convert.command(A(cmd_j), device="cpu"),
            convert.controller_carry(A(carry_j), device="cpu"),
            convert.robot_obs(A(obs_j), device="cpu"))
    return (robot_j, mpc_j, gait_j, cmd_j, carry_j, obs_j), port


@pytest.mark.parametrize("solver", ["admm_fast", "riccati", "admm", "ipm", "ipm_parity"])
def test_nan_poisoned_solve_matches_jax(solver):
    """Scenario 0's ``lin_vel_base`` is NaN on the second solve tick
    (tests/test_fault_and_fast_loop.py:104).  ``admm_fast``, ``riccati``
    and ``admm`` return a non-finite solve, so the guard holds scenario 0's
    previous forces bit for bit; ``ipm`` and ``ipm_parity`` return finite
    zero forces for it, in JAX too, so the hold does not fire (ROADMAP
    watch list).  Scenario 1 solves normally in every case."""
    (robot_j, mpc_j, gait_j, cmd_j, carry_j, obs_j), (robot, mpc, gait, cmd, carry, obs) = \
        _nan_setup()
    jstep = jax.jit(lambda c, o, t: jctrl.step_batch(robot_j, mpc_j, gait_j, cmd_j, c, o, t,
                                                     solver=solver))
    carry_j, out0_j = jstep(carry_j, obs_j, jnp.int32(0))
    bad_j = obs_j.replace(lin_vel_base=obs_j.lin_vel_base.at[0, 0].set(jnp.nan))
    _, out1_j = jstep(carry_j, bad_j, jnp.int32(20))
    f0_j, f1_j = np.asarray(out0_j.contact_forces), np.asarray(out1_j.contact_forces)

    carry, out0 = controller.step_batch(robot, mpc, gait, cmd, carry, obs, 0, solver=solver)
    bad = dataclasses.replace(obs, lin_vel_base=obs.lin_vel_base.clone())
    bad.lin_vel_base[0, 0] = float("nan")
    _, out1 = controller.step_batch(robot, mpc, gait, cmd, carry, bad, 20, solver=solver)
    f0, f1 = out0.contact_forces.numpy(), out1.contact_forces.numpy()

    assert np.isfinite(f0).all() and np.isfinite(f1).all()
    if solver in ("ipm", "ipm_parity"):
        np.testing.assert_array_equal(f1_j[0], np.zeros(12, np.float32))
        np.testing.assert_array_equal(f1[0], np.zeros(12, np.float32))
    else:
        np.testing.assert_array_equal(f1_j[0], f0_j[0])
        np.testing.assert_array_equal(f1[0], f0[0])
    assert not np.array_equal(f1[1], f0[1])
    # Scenario 1 is untouched by scenario 0's fault: the first-step forces
    # agree with JAX's at the solvers' lockstep bars.
    np.testing.assert_allclose(f1[1], f1_j[1], atol=1.5)
