"""lie / kin / srb / gaitsched: the port against the JAX package.

Inputs are random batches made with numpy; the JAX functions run per
scenario under ``vmap``, the port's with a leading batch axis.  Tolerances:
rtol = atol = 1e-5 for arithmetic; 1e-4 where the output goes through a
transcendental (sin/cos/atan2/asin/acos/sqrt): XLA:CPU and PyTorch use
different f32 implementations that differ by a few ulp, and the kinematic
chains sum several such terms at unit scale.  Integer gait tables are
compared exactly.  ``srb.state_space``'s unchecked inverse is also held bit
for bit to the checked one, and a singular inertia row to the JAX module's
non-finite answer and to the controller's hold of that row's forces.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.models.gaits import Gaits as JGaits
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.ops import gaitsched as jgaitsched
from pympc_quadruped_tpu.ops import kin as jkin
from pympc_quadruped_tpu.ops import lie as jlie
from pympc_quadruped_tpu.ops import srb as jsrb

from pympc_quadruped_tpu_torch import convert, tree
from pympc_quadruped_tpu_torch.control import controller
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.models import Command, Gaits, MpcParams, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.models.robots import LEG_NAMES
from pympc_quadruped_tpu_torch.ops import gaitsched, kin, lie, srb
from pympc_quadruped_tpu_torch.ops.qp import admm, admm_fast, ipm, riccati

torch.set_num_threads(1)

B = 16
ARITH = dict(rtol=1e-5, atol=1e-5)
TRANSC = dict(rtol=1e-4, atol=1e-4)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return {
        "quat": _unit_quats(rng, B),
        "rpy": rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32),
        "theta": rng.uniform(-3.0, 3.0, B).astype(np.float32),
        "vec": f(B, 3),
        "A": f(B, 3, 3) + 3.0 * np.eye(3, dtype=np.float32),
        "omega": f(B, 3),
    }


def _cmp(jax_out, port_out, tol):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), **tol)


LIE_CASES = {
    "quat_to_rotmat": (lambda d: (d["quat"],), ARITH),
    "quat_to_zyx": (lambda d: (d["quat"],), TRANSC),
    "zyx_to_rotmat": (lambda d: (d["rpy"],), TRANSC),
    "rotmat_to_quat": (lambda d: (np.asarray(jax.vmap(jlie.zyx_to_rotmat)(d["rpy"])),), TRANSC),
    "skew": (lambda d: (d["vec"],), ARITH),
    "solve3": (lambda d: (d["A"], d["vec"]), ARITH),
    "rot_x": (lambda d: (d["theta"],), TRANSC),
    "rot_y": (lambda d: (d["theta"],), TRANSC),
    "rot_z": (lambda d: (d["theta"],), TRANSC),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    make, tol = LIE_CASES[name]
    args = make(_inputs())
    j = jax.vmap(getattr(jlie, name))(*[jnp.asarray(a) for a in args])
    p = getattr(lie, name)(*[torch.tensor(np.asarray(a)) for a in args])
    _cmp(j, p, tol)


def test_quat_integrate_matches_jax():
    d = _inputs(1)
    dt = np.float32(0.001)
    j = jax.vmap(lambda q, w: jlie.quat_integrate(q, w, dt))(d["quat"], d["omega"])
    p = lie.quat_integrate(torch.from_numpy(d["quat"]), torch.from_numpy(d["omega"]),
                           torch.tensor(dt))
    _cmp(j, p, TRANSC)


def _robots():
    jr = jaliengo()
    return jr, convert.robot_params(convert.as_arrays(jr), device="cpu")


def _joint_batch(seed):
    rng = np.random.default_rng(seed)
    q = np.tile(np.array([0.0, 0.8, -1.6], np.float32), (B, 4, 1))
    return (q + rng.uniform(-0.3, 0.3, q.shape)).astype(np.float32)


@pytest.mark.parametrize("fn", ["leg_forward_kinematics", "thigh_positions"])
def test_leg_kinematics_matches_jax(fn):
    jr, pr = _robots()
    q = _joint_batch(2)
    j = jax.vmap(lambda qq: getattr(jkin, fn)(jr, qq))(q)
    p = getattr(kin, fn)(pr, torch.from_numpy(q))
    for a, b in zip(jax.tree.leaves(j), p if isinstance(p, tuple) else (p,)):
        _cmp(a, b, TRANSC)


def test_leg_inverse_kinematics_matches_jax_and_inverts_fk():
    jr, pr = _robots()
    q = _joint_batch(3)
    feet = np.asarray(jax.vmap(lambda qq: jkin.leg_forward_kinematics(jr, qq)[0])(q))
    j = jax.vmap(lambda f: jkin.leg_inverse_kinematics(jr, f))(feet)
    p = kin.leg_inverse_kinematics(pr, torch.from_numpy(feet))
    _cmp(j, p, TRANSC)
    np.testing.assert_allclose(p.numpy(), q, atol=1e-4)


def test_compute_kin_state_matches_jax():
    jr, pr = _robots()
    rng = np.random.default_rng(4)
    obs = {
        "pos_base": rng.normal(scale=0.3, size=(B, 3)).astype(np.float32),
        "lin_vel_base": rng.normal(size=(B, 3)).astype(np.float32),
        "quat_base": _unit_quats(rng, B),
        "ang_vel_base": rng.normal(size=(B, 3)).astype(np.float32),
        "q": _joint_batch(5).reshape(B, 12),
        "qdot": rng.normal(size=(B, 12)).astype(np.float32),
    }
    jobs = jkin.RobotObs(**{k: jnp.asarray(v) for k, v in obs.items()})
    j = jax.vmap(lambda o: jkin.compute_kin_state(jr, o))(jobs)
    p = kin.compute_kin_state(pr, convert.robot_obs(obs, device="cpu"))
    for f in dataclasses.fields(p):
        _cmp(getattr(j, f.name), getattr(p, f.name), TRANSC)


def test_joint_order_contract():
    """Legs FL, FR, RL, RR; joints (hip, thigh, calf); the FK of each leg
    lands in its own quadrant; gait tables are (step, leg) row-major."""
    assert LEG_NAMES == ("FL", "FR", "RL", "RR")
    hips = aliengo(device="cpu").hip_offset.numpy()
    np.testing.assert_array_equal(np.sign(hips[:, :2]),
                                  [[1, 1], [1, -1], [-1, 1], [-1, -1]])
    q0 = torch.tensor([0.0, 0.8, -1.6]).repeat(4, 1)
    feet, _ = kin.leg_forward_kinematics(aliengo(device="cpu"), q0)
    np.testing.assert_array_equal(np.sign(feet[:, :2].numpy()),
                                  [[1, 1], [1, -1], [-1, 1], [-1, -1]])
    table = gaitsched.gait_table(Gaits.trotting10(device="cpu"), MpcParams(horizon=10), 0)
    for row in table.reshape(10, 4).numpy():
        assert row[0] == row[3] and row[1] == row[2] and row[0] != row[1]


def test_state_space_and_discretize_match_jax():
    jr, pr = _robots()
    rng = np.random.default_rng(6)
    yaw = rng.uniform(-1.0, 1.0, B).astype(np.float32)
    feet = (np.array([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                      [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]])
            + rng.normal(scale=0.03, size=(B, 4, 3))).astype(np.float32)
    jm = JMpcParams(horizon=16)
    Acj, Bcj = jax.vmap(lambda y, p: jsrb.state_space(jr, y, p))(yaw, feet)
    Adj, Bdj = jax.vmap(lambda a, b: jsrb.discretize(a, b, jm.dt_predict))(Acj, Bcj)
    prb = tree.tile(pr, B)
    Ac, Bc = srb.state_space(prb, torch.from_numpy(yaw), torch.from_numpy(feet))
    Ad, Bd = srb.discretize(Ac, Bc, MpcParams().dt_predict)
    for a, b in [(Acj, Ac), (Bcj, Bc), (Adj, Ad), (Bdj, Bd)]:
        _cmp(a, b, TRANSC)


def _state_space_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    yaw = torch.from_numpy(rng.uniform(-3.0, 3.0, B)).to(dtype)
    feet = torch.from_numpy(np.array([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                                      [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]])
                            + rng.normal(scale=0.05, size=(B, 4, 3))).to(dtype)
    robot = tree.tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                          tree.tile(_robots()[1], B))
    return robot, yaw, feet


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [11, 12])
def test_state_space_bitwise_the_checked_inverse(monkeypatch, dtype, seed):
    """``state_space`` inverts the inertia once, with ``inv_ex`` (no error
    check on the host, so no synchronisation on a card), and Ac and Bc are
    bit for bit what the checked ``torch.linalg.inv`` in its place gives,
    on random yaws and feet."""
    robot, yaw, feet = _state_space_inputs(seed, dtype)
    Ac, Bc = srb.state_space(robot, yaw, feet)
    calls = []

    def checked(A):
        calls.append(A.shape)
        return torch.linalg.inv(A), torch.zeros(A.shape[:-2], dtype=torch.int32)

    monkeypatch.setattr(torch.linalg, "inv_ex", checked)
    Ac_inv, Bc_inv = srb.state_space(robot, yaw, feet)
    assert calls == [(B, 3, 3)]
    assert Ac.dtype == Bc.dtype == dtype
    assert torch.equal(Ac, Ac_inv) and torch.equal(Bc, Bc_inv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_state_space_singular_inertia_row_is_nonfinite_alone(dtype):
    """A singular (zero) inertia in one row gives non-finite torque rows of
    Bc in that row alone, without raising, as the JAX module's
    ``jnp.linalg.inv`` does; every other entry is bitwise unchanged."""
    robot, yaw, feet = _state_space_inputs(13, dtype)
    bad = dataclasses.replace(robot, inertia=robot.inertia.clone())
    bad.inertia[3] = 0.0
    Ac, Bc = srb.state_space(robot, yaw, feet)
    Ac_bad, Bc_bad = srb.state_space(bad, yaw, feet)
    others = torch.arange(B) != 3
    assert torch.equal(Ac_bad, Ac)
    assert torch.equal(Bc_bad[others], Bc[others])
    assert not torch.isfinite(Bc_bad[3, 6:9]).any()
    assert torch.equal(Bc_bad[3, :6], Bc[3, :6]) and torch.equal(Bc_bad[3, 9:], Bc[3, 9:])
    jr = jaliengo()
    _, Bcj = jsrb.state_space(jr.replace(inertia=jnp.zeros_like(jr.inertia)),
                              jnp.float32(yaw[3]), jnp.asarray(feet[3].float().numpy()))
    np.testing.assert_array_equal(np.isfinite(np.asarray(Bcj)), torch.isfinite(Bc_bad[3]).numpy())


@pytest.mark.parametrize("solver", ["riccati", "admm_fast"])
def test_solve_branch_holds_forces_of_a_singular_inertia_row(solver):
    """One solve tick whose robot row 0 has a singular inertia: that row's
    solve comes back non-finite and keeps its held forces bit for bit, and
    every other row's forces are bitwise those of the same call with the
    row's inertia intact (h=10 trot from the nominal stance, B=4)."""
    Bs, h = 4, 10
    mpc = default_mpc_params(h, device="cpu")
    robot = tree.tile(aliengo(device="cpu"), Bs)
    gait = tree.tile(Gaits.trotting10(device="cpu"), Bs)
    cmd = tree.tile(Command.trot_forward(0.6, device="cpu"), Bs)
    carry = tree.tile(controller.init_carry(h, device="cpu"), Bs)
    obs = srb_env.observe(robot, srb_env.default_init_state(robot))
    carry, _ = controller.step_batch(robot, mpc, gait, cmd, carry, obs, 0, solver=solver)
    held = carry.mpc.contact_forces
    ks, _, table, x_t, mpc_carry, vel = controller._pre_solve(robot, mpc, gait, cmd, carry,
                                                              obs, 20)
    cfgs = (ipm.IpmConfig(), admm.AdmmConfig(), admm_fast.AdmmFastConfig.inloop(),
            riccati.RiccatiConfig.inloop())
    solve = lambda r: controller._solve_branch(r, mpc, cmd, mpc_carry, ks, x_t, vel, table,
                                               solver, *cfgs)
    bad = dataclasses.replace(robot, inertia=robot.inertia.clone())
    bad.inertia[0] = 0.0
    carry_ok, forces_ok = solve(robot)
    carry_bad, forces_bad = solve(bad)
    assert torch.isfinite(held).all() and held.abs().max() > 1.0
    assert not torch.equal(forces_ok[0], held[0])
    assert torch.equal(forces_bad[0], held[0])
    assert torch.equal(forces_bad[1:], forces_ok[1:])
    assert torch.equal(carry_bad.contact_forces, forces_bad)
    # The failed row restarts cold; the others keep their warm start.
    assert not carry_bad.qp_primal[0].any() and not carry_bad.qp_dual[0].any()
    assert torch.equal(carry_bad.qp_primal[1:], carry_ok.qp_primal[1:])


def test_pack_state_matches_jax():
    d = _inputs(7)
    j = jax.vmap(lambda a, b, c, e: jsrb.pack_state(a, b, c, e, JMpcParams()))(
        d["rpy"], d["vec"], d["omega"], d["vec"])
    p = srb.pack_state(*[torch.from_numpy(d[k]) for k in ("rpy", "vec", "omega", "vec")],
                       MpcParams())
    _cmp(j, p, ARITH)


GAIT_NAMES = ["standing", "trotting16", "trotting10", "jumping16", "pacing16",
              "pacing10", "bounding8"]


@pytest.mark.parametrize("name", GAIT_NAMES)
def test_gaitsched_matches_jax(name):
    """Every phase function over ticks covering several cycles, the port's
    gait tiled to a batch of 3: tables and segment indices exactly, phases
    at 1e-6 (one f32 division each side)."""
    jg, jm = JGaits.by_name(name), JMpcParams(horizon=16)
    pg, pm = tree.tile(Gaits.by_name(name, device="cpu"), 3), MpcParams(horizon=16)
    for tick in (0, 1, 19, 20, 159, 160, 333, 1000, 4321):
        t = jnp.int32(tick)
        it_j, ph_j = jgaitsched.phase_of_tick(jg, jm, t)
        it_p, ph_p = gaitsched.phase_of_tick(pg, pm, tick)
        assert (it_p.numpy() == int(it_j)).all()
        np.testing.assert_allclose(ph_p.numpy(), float(ph_j), rtol=1e-6)
        np.testing.assert_array_equal(
            gaitsched.gait_table(pg, pm, tick).numpy()[0],
            np.asarray(jgaitsched.gait_table(jg, jm, t)))
        for fn in ("swing_state", "stance_state"):
            np.testing.assert_allclose(
                getattr(gaitsched, fn)(pg, pm, tick).numpy()[1],
                np.asarray(getattr(jgaitsched, fn)(jg, jm, t)), rtol=1e-6, atol=1e-7)
    for fn in ("swing_time", "stance_time"):
        np.testing.assert_allclose(getattr(gaitsched, fn)(pg, pm).numpy(),
                                   float(getattr(jgaitsched, fn)(jg, jm)), rtol=1e-6)
