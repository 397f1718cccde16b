"""The port's golden lockstep: ``controller.step_batch`` against the float64
oracle and against the JAX controller on the same synthetic observations.

1. ``solver="ipm_parity"`` (float64 condensing + the IPM's parity
   configuration, solved in float64) against ``npref.OracleController`` over the 200 ticks of
   tests/test_golden_lockstep.py (Aliengo, TROTTING10 at 1.2 m/s, h=10,
   B=1: 10 solves), with its bars: GRFs within 1e-4 relative on every
   solve tick, total vertical support within 1e-5, swing-leg torques
   within 2e-3 and all torques within 1e-3 relative, swing states equal,
   forces held exactly between solves.
2. The f32 parity solvers, ``"admm"`` and ``"ipm"``, in tick lockstep with
   the JAX controller: h=10, B=2 (scenario 1's observations offset by a
   few mm and cm/s), 60 ticks = 3 solves.  Held forces are compared on
   each solve tick's total vertical support (SUPPORT_ATOL) and on cost:
   the QP the tick solved is rebuilt from the port's carry, the port's
   route solves it to exactly the held forces, and its f64 cost is within
   COST_RTOL of the JAX route's solve of the same QP.  Torques within
   TORQUE_ATOL of JAX's.  The f32 condensed QP is ill-conditioned
   (reduced-Hessian lambda_min ~ 2R = 4e-5), so per-component forces are
   not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.control import controller as jctrl
from pympc_quadruped_tpu.models.command import Command as JCommand
from pympc_quadruped_tpu.models.gaits import Gaits as JGaits
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.ops import kin as jkin
from pympc_quadruped_tpu.ops.qp import admm as jadmm
from pympc_quadruped_tpu.ops.qp import cones as jcones
from pympc_quadruped_tpu.ops.qp import ipm as jipm
from pympc_quadruped_tpu.oracle import npref

from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.control import controller, refmpc
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.ops.kin import RobotObs
from pympc_quadruped_tpu_torch.ops.qp import admm, cones, ipm
from test_golden_lockstep import HORIZON, NUM_TICKS, synthetic_obs

torch.set_num_threads(1)

LOCK_B, LOCK_TICKS = 2, 60
# Measured over the 3 solves of both solvers: vertical support up to 0.12 N
# (of ~90 N), f64 relative cost difference up to 3.5e-8, torques up to
# 0.11 N m (the ipm; the admm 0.05 N m).  The bars are 3-10x those.
SUPPORT_ATOL, COST_RTOL, TORQUE_ATOL = 0.5, 3e-7, 0.3
OBS_OFFSET = {"pos": [0.0, 0.0, 0.004], "vel": [0.02, -0.01, 0.0]}


def _obs(tick, B=1):
    """synthetic_obs(tick) for B scenarios (scenario b > 0 offset by
    OBS_OFFSET), as float32 numpy arrays keyed by RobotObs field."""
    rows = []
    for b in range(B):
        o = synthetic_obs(tick)
        if b:
            o["pos"] = o["pos"] + OBS_OFFSET["pos"]
            o["vel"] = o["vel"] + OBS_OFFSET["vel"]
        rows.append(o)
    stack = lambda k: np.stack([r[k] for r in rows]).astype(np.float32)
    return {"pos_base": stack("pos"), "lin_vel_base": stack("vel"),
            "quat_base": stack("quat"), "ang_vel_base": stack("omega"),
            "q": stack("q"), "qdot": stack("qdot")}


def _port_setup(B):
    dev = "cpu"
    return (tree.tile(aliengo(device=dev), B), default_mpc_params(HORIZON, device=dev),
            tree.tile(Gaits.trotting10(device=dev), B),
            tree.tile(Command.trot_forward(1.2, device=dev), B),
            tree.tile(controller.init_carry(HORIZON, device=dev), B))


@pytest.fixture(scope="module")
def golden():
    robot, mpc, gait, cmd, carry = _port_setup(1)
    octrl = npref.OracleController(npref.oracle_aliengo(), npref.OracleConfig(horizon=HORIZON),
                                   npref.OracleGait.trotting10())
    port, oracle = [], []
    for tick in range(NUM_TICKS):
        obs = RobotObs(**{k: torch.tensor(v) for k, v in _obs(tick).items()})
        carry, out = controller.step_batch(robot, mpc, gait, cmd, carry, obs, tick,
                                           solver="ipm_parity")
        port.append({"forces": out.contact_forces[0].double().numpy(),
                     "torques": out.torques[0].double().numpy(),
                     "swing_states": out.swing_states[0].double().numpy()})
        oracle.append(octrl.step(synthetic_obs(tick), [1.2, 0.0, 0.0], 0.0, tick))
    return port, oracle


SOLVE_TICKS = range(0, NUM_TICKS, 20)


def test_golden_swing_states_match(golden):
    port, oracle = golden
    for tick in range(NUM_TICKS):
        np.testing.assert_allclose(port[tick]["swing_states"], oracle[tick]["swing_states"],
                                   atol=1e-5)


def test_golden_grf_match(golden):
    port, oracle = golden
    worst = max(np.max(np.abs(port[t]["forces"] - oracle[t]["forces"])
                       / (1.0 + np.abs(oracle[t]["forces"]))) for t in SOLVE_TICKS)
    assert worst < 1e-4, f"worst GRF relative error {worst:.2e}"


def test_golden_vertical_support_match(golden):
    port, oracle = golden
    for t in SOLVE_TICKS:
        fz_p = port[t]["forces"].reshape(4, 3)[:, 2].sum()
        fz_o = oracle[t]["forces"].reshape(4, 3)[:, 2].sum()
        assert abs(fz_p - fz_o) / (1.0 + abs(fz_o)) < 1e-5, (t, fz_p, fz_o)


def test_golden_swing_torques_match(golden):
    port, oracle = golden
    worst = 0.0
    for t in range(NUM_TICKS):
        for leg in np.flatnonzero(oracle[t]["swing_states"] > 0):
            sl = slice(3 * leg, 3 * leg + 3)
            t_p, t_o = port[t]["torques"][sl], oracle[t]["torques"][sl]
            worst = max(worst, np.max(np.abs(t_p - t_o) / (1.0 + np.abs(t_o))))
    assert worst < 2e-3, f"worst swing torque relative error {worst:.2e}"


def test_golden_all_torques_match(golden):
    port, oracle = golden
    worst = max(np.max(np.abs(port[t]["torques"] - oracle[t]["torques"])
                       / (1.0 + np.abs(oracle[t]["torques"]))) for t in range(NUM_TICKS))
    assert worst < 1e-3, f"worst torque relative error {worst:.2e}"


def test_golden_forces_held_between_solves(golden):
    port, _ = golden
    for t in range(NUM_TICKS):
        if t % 20:
            np.testing.assert_array_equal(port[t]["forces"], port[t - 1]["forces"])


def _port_qp(robot, mpc, gait, cmd, carry, obs, tick):
    """The QP a solve tick at ``tick`` builds from ``carry`` (the controller's
    own pre-solve, reference and condensing steps)."""
    ks, _, table, x_t, mpc_carry, vel = controller._pre_solve(robot, mpc, gait, cmd, carry,
                                                              obs, tick)
    _, X = refmpc.reference_trajectory(mpc_carry, x_t, vel, cmd, mpc, robot, table)
    H, g, mv = refmpc.build_qp(robot, mpc, x_t, x_t[:, 2], ks.pos_base_feet, X, table)
    return H, g, mv, table


def _solve_both(solver, H, g, table, mpc):
    """Full-horizon solutions of the port's and JAX's route on (H, g)."""
    mpc_j = JMpcParams(horizon=HORIZON)
    Hj, gj, tj = (jnp.asarray(t.numpy()) for t in (H, g, table))
    if solver == "ipm":
        G, h_vec, _ = cones.block_constraints(table, 500.0, mpc)
        U = ipm.solve_batch(H, g, G, h_vec)
        Gj, hj, _ = jax.vmap(lambda t: jcones.block_constraints(t, 500.0, mpc_j))(tj)
        U_j = jipm.solve_batch(Hj, gj, Gj, hj)
    else:
        A, l, u = admm.admm_constraints(table, 500.0, mpc)
        U = admm.solve_batch(H, g, A, l, u)
        Aj, lj, uj = jax.vmap(lambda t: jadmm.admm_constraints(t, 500.0, mpc_j))(tj)
        U_j = jadmm.solve_batch(Hj, gj, Aj, lj, uj)
    return U, np.asarray(U_j, np.float64)


@pytest.mark.parametrize("solver", ["admm", "ipm"])
def test_tick_lockstep_against_jax_controller(solver):
    B = LOCK_B
    robot, mpc, gait, cmd, carry = _port_setup(B)
    tile = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), t)
    robot_j, gait_j, cmd_j = tile(jaliengo()), tile(JGaits.trotting10()), tile(
        JCommand.trot_forward(1.2))
    mpc_j = JMpcParams(horizon=HORIZON)
    carry_j = tile(jctrl.init_carry(HORIZON))
    step_j = jax.jit(lambda c, o, t: jctrl.step_batch(robot_j, mpc_j, gait_j, cmd_j, c, o, t,
                                                      solver=solver))
    for tick in range(LOCK_TICKS):
        arrays = _obs(tick, B)
        obs = RobotObs(**{k: torch.tensor(v) for k, v in arrays.items()})
        if tick % 20 == 0:
            H, g, mv, table = _port_qp(robot, mpc, gait, cmd, carry, obs, tick)
        carry, out = controller.step_batch(robot, mpc, gait, cmd, carry, obs, tick,
                                           solver=solver)
        carry_j, out_j = step_j(carry_j, jkin.RobotObs(**arrays), jnp.int32(tick))
        f, f_j = out.contact_forces.double().numpy(), np.asarray(out_j.contact_forces, np.float64)
        np.testing.assert_allclose(out.torques.numpy(), np.asarray(out_j.torques),
                                   atol=TORQUE_ATOL)
        if tick % 20:
            continue
        support = lambda F: F.reshape(B, 4, 3)[:, :, 2].sum(-1)
        np.testing.assert_allclose(support(f), support(f_j), atol=SUPPORT_ATOL)
        U, U_j = _solve_both(solver, H, g, table, mpc)
        assert torch.equal(out.contact_forces, (U * mv)[:, :12])
        Hd, gd, mvd = H.double().numpy(), g.double().numpy(), mv.double().numpy()
        cost = lambda V: 0.5 * np.einsum("bi,bij,bj->b", V, Hd, V) + np.sum(gd * V, -1)
        c, c_j = cost(U.double().numpy() * mvd), cost(U_j * mvd)
        assert np.all(np.abs(c - c_j) / (np.abs(c_j) + 1.0) < COST_RTOL), (tick, c, c_j)
