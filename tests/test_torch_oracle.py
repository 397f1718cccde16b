"""The port's float64 golden model (``pympc_quadruped_tpu_torch/oracle``)
against the JAX package's (``pympc_quadruped_tpu/oracle``), on the CPU.

- every function and dataclass of npref at 1e-12, for both robots and the
  seven gaits by name, ``kin_update`` with and without ``vel_quirk``;
- ``solve_qp_kkt`` on tests/test_qp.py's h=10 instances (ticks 0, 100,
  340, 660) and tests/test_riccati.py's h=16 trotting16 / jumping16
  instances (ticks 0, 7, 19): U within 1e-8 of (1 + |U|), certificate
  below 1e-9; each horizon's instances in one batched call, each row
  within 1e-10 of its call alone; an indefinite H raises alone and is a NaN
  row in a batch whose other rows stay bit for bit;
- ``OracleController`` in 200-tick lockstep with JAX's on
  tests/test_golden_lockstep.py's observations: forces and torques within
  1e-9 of (1 + |x|), swing states equal, ``last_kkt`` set on the same
  ticks and within 1e-12 (the two frameworks round the residual products
  differently, so the certificates are not bit for bit; measured <= 7.3e-13);
- the port's C++ ``solve_qp`` (its own copy of native/qp_oracle.cc, built
  with the same flags): tests/test_cpp_oracle.py's three checks against
  the port's npref, and bit for bit JAX's ``cpp.solve_qp``.

Inputs are made with numpy from seeds.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.oracle import cpp as jcpp
from pympc_quadruped_tpu.oracle import npref as J
from pympc_quadruped_tpu_torch.oracle import cpp as pcpp
from pympc_quadruped_tpu_torch.oracle import npref as P
from test_golden_lockstep import synthetic_obs
from test_qp import _mpc_instance
from test_riccati import _instance

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAITS = ("standing", "trotting10", "trotting16", "pacing10", "pacing16", "jumping16",
         "bounding8")
ROBOTS = ("aliengo", "a1")
FN_BAR, U_BAR, KKT_BAR, BATCH_BAR, LOCKSTEP_BAR = 1e-12, 1e-8, 1e-9, 1e-10, 1e-9
H10_TICKS, H16_CASES = (0, 100, 340, 660), [(g, t) for g in ("trotting16", "jumping16")
                                             for t in (0, 7, 19)]


def close(got, want, bar=FN_BAR):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want) / (1.0 + np.abs(want)), initial=0.0)
    assert err < bar, err


def robots(name):
    return getattr(J, f"oracle_{name}")(), getattr(P, f"oracle_{name}")(CPU)


def random_obs(rng):
    quat = rng.normal(size=4)
    return {"pos": rng.normal(size=3), "vel": rng.normal(size=3),
            "quat": quat / np.linalg.norm(quat), "omega": rng.normal(size=3),
            "q": np.tile([0.0, 0.8, -1.6], 4) + 0.3 * rng.normal(size=12),
            "qdot": rng.normal(size=12)}


# ---------------------------------------------------------------- functions


def test_rotations():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        close(P.quat_to_rotmat(q, CPU), J.quat_to_rotmat(q))
        close(P.quat_to_zyx(q, CPU), J.quat_to_zyx(q))
        t, v = rng.uniform(-4, 4), rng.normal(size=3)
        close(P.rot_z(t, CPU), J.rot_z(t))
        close(P.skew(v, CPU), J.skew(v))


@pytest.mark.parametrize("name", ROBOTS)
def test_robot_params(name):
    jr, pr = robots(name)
    for f in dataclasses.fields(J.OracleRobot):
        close(getattr(pr, f.name), getattr(jr, f.name))


def test_config():
    jc, pc = J.OracleConfig(horizon=10), P.OracleConfig(horizon=10, device=CPU)
    for f in dataclasses.fields(J.OracleConfig):
        close(getattr(pc, f.name), getattr(jc, f.name))
    assert pc.dt_gait == jc.dt_gait
    q = np.arange(13.0)
    close(P.OracleConfig(q_diag=q, device=CPU).q_diag, q)


@pytest.mark.parametrize("gait", GAITS)
def test_gait_schedule(gait):
    jg, pg = J.OracleGait.by_name(gait), P.OracleGait.by_name(gait, CPU)
    assert pg.num_segments == jg.num_segments
    np.testing.assert_array_equal(pg.stance_offsets.numpy(), jg.stance_offsets)
    np.testing.assert_array_equal(pg.stance_durations.numpy(), jg.stance_durations)
    for h in (8, 10, 16):
        jc, pc = J.OracleConfig(horizon=h), P.OracleConfig(horizon=h, device=CPU)
        assert P.swing_time(pg, pc) == J.swing_time(jg, jc)
        assert P.stance_time(pg, pc) == J.stance_time(jg, jc)
        for tick in range(0, 700, 7):
            assert P.gait_phase(pg, pc, tick) == J.gait_phase(jg, jc, tick)
            np.testing.assert_array_equal(P.gait_table(pg, pc, tick).numpy(),
                                          J.gait_table(jg, jc, tick))
            close(P.swing_state(pg, pc, tick), J.swing_state(jg, jc, tick))


def test_window():
    rng = np.random.default_rng(1)
    for _ in range(50):
        phase, off = rng.uniform(0, 1), rng.uniform(0, 1, 4)
        dur = np.where(rng.uniform(size=4) < 0.2, 0.0, rng.uniform(0, 1, 4))
        close(P._window(phase, torch.tensor(off), torch.tensor(dur)), J._window(phase, off, dur))


@pytest.mark.parametrize("name", ROBOTS)
@pytest.mark.parametrize("vel_quirk", [True, False])
def test_kinematics(name, vel_quirk):
    jr, pr = robots(name)
    rng = np.random.default_rng(2)
    for _ in range(10):
        obs = random_obs(rng)
        q = obs["q"].reshape(4, 3)
        for got, want in zip(P.leg_fk(pr, q), J.leg_fk(jr, q)):
            close(got, want)
        close(P.thigh_pos(pr, q), J.thigh_pos(jr, q))
        pk, jk = P.kin_update(pr, obs, vel_quirk), J.kin_update(jr, obs, vel_quirk)
        for f in dataclasses.fields(J.OracleKin):
            close(getattr(pk, f.name), getattr(jk, f.name))
        # Tensors in, on the robot's device, give the same kinematics.
        tk = P.kin_update(pr, {k: torch.tensor(v) for k, v in obs.items()}, vel_quirk)
        close(tk.vel_rel_base, jk.vel_rel_base)


@pytest.mark.parametrize("name", ROBOTS)
@pytest.mark.parametrize("h", [10, 16])
def test_condensed_qp(name, h):
    """H and g at 1e-12 of max|H| and max|g|; the batched call against the
    calls alone."""
    jr, pr = robots(name)
    jc = J.OracleController(jr, J.OracleConfig(horizon=h), J.OracleGait.trotting10())
    pc = P.OracleController(pr, P.OracleConfig(horizon=h, device=CPU), P.OracleGait.trotting10(CPU))
    rng = np.random.default_rng(3)
    args = [(rng.normal(size=13), rng.uniform(-3, 3), rng.normal(scale=0.3, size=(4, 3)),
             rng.normal(size=13 * h)) for _ in range(3)]
    Hb, gb = pc._condensed_qp(*(np.stack(a) for a in zip(*args)))
    for i, a in enumerate(args):
        (pH, pg), (jH, jg) = pc._condensed_qp(*a), jc._condensed_qp(*a)
        close(pH / np.abs(jH).max(), jH / np.abs(jH).max())
        close(pg / np.abs(jg).max(), jg / np.abs(jg).max())
        close(Hb[i], pH)
        close(gb[i], pg)


def test_reference_traj():
    """The reference trajectory and its written-back carry (clamps and
    integrators), on the host-scalar state the controller branches on."""
    jc = J.OracleController(J.oracle_aliengo(), J.OracleConfig(horizon=10),
                            J.OracleGait.trotting10())
    pc = P.OracleController(P.oracle_aliengo(CPU), P.OracleConfig(horizon=10, device=CPU),
                            P.OracleGait.trotting10(CPU))
    rng = np.random.default_rng(4)
    for _ in range(20):
        x_t, vel, yaw_rate = rng.normal(scale=0.5, size=13), rng.normal(size=3), rng.normal()
        close(pc._reference_traj(x_t, vel, yaw_rate), jc._reference_traj(x_t, vel, yaw_rate))
        for k in ("xpos_des", "ypos_des", "roll_int", "pitch_int"):
            assert getattr(pc, k) == getattr(jc, k), k


# ---------------------------------------------------------------- QP oracle


def h10(tick):
    _, _, H, g, table = _mpc_instance(tick)
    return H, g, table


def h16(gait, tick):
    *_, table, H, g = _instance(tick, horizon=16, gait=gait, vx=0.5, vel_err=0.3)
    return H, g, table


def check_solution(H, g, table):
    U, kkt = P.solve_qp_kkt(H, g, 0.7, 500.0, table, device=CPU)
    U_ref, kkt_ref = J.solve_qp_kkt(H, g, 0.7, 500.0, table)
    assert max(kkt_ref) < KKT_BAR and float(kkt.max()) < KKT_BAR, (kkt, kkt_ref)
    close(U, U_ref, U_BAR)
    return U


@pytest.mark.parametrize("tick", H10_TICKS)
def test_solve_qp_kkt_h10(tick):
    check_solution(*h10(tick))


@pytest.mark.parametrize("gait,tick", H16_CASES)
def test_solve_qp_kkt_h16(gait, tick):
    check_solution(*h16(gait, tick))


@pytest.mark.parametrize("h", [10, 16])
def test_solve_qp_kkt_batched(h):
    """Each horizon's instances in one call: every row within 1e-10 of its
    call alone, and of the same certificate quality."""
    insts = [h10(t) for t in H10_TICKS] if h == 10 else [h16(*c) for c in H16_CASES]
    H, g, table = (np.stack(a) for a in zip(*insts))
    U, kkt = P.solve_qp_kkt(H, g, 0.7, 500.0, table, device=CPU)
    assert U.shape == g.shape and kkt.shape == (len(insts), 3)
    for i, inst in enumerate(insts):
        U1, kkt1 = P.solve_qp_kkt(*inst[:2], 0.7, 500.0, inst[2], device=CPU)
        close(U[i], U1, BATCH_BAR)
        assert float(kkt[i].max()) < KKT_BAR


def test_solve_qp_kkt_indefinite():
    """An indefinite H: alone it raises; in a batch its row is NaN and the
    other rows are bit for bit what they are beside a definite H."""
    insts = [h10(t) for t in H10_TICKS]
    H, g, table = (np.stack(a) for a in zip(*insts))
    with pytest.raises(torch.linalg.LinAlgError):
        P.solve_qp_kkt(-H[1], g[1], 0.7, 500.0, table[1], device=CPU)
    U, kkt = P.solve_qp_kkt(H, g, 0.7, 500.0, table, device=CPU)
    H_bad = H.copy()
    H_bad[1] = -H[1]
    U_bad, kkt_bad = P.solve_qp_kkt(H_bad, g, 0.7, 500.0, table, device=CPU)
    assert bool(torch.isnan(U_bad[1]).all()) and bool(torch.isnan(kkt_bad[1]).all())
    others = [0, 2, 3]
    assert torch.equal(U_bad[others], U[others]) and torch.equal(kkt_bad[others], kkt[others])


# ---------------------------------------------------------------- controller


LOCKSTEP_CASES = [("aliengo", "trotting10", 10), ("a1", "standing", 16),
                  ("aliengo", "pacing16", 16)]


@pytest.mark.parametrize("robot,gait,h", LOCKSTEP_CASES)
def test_controller_lockstep(robot, gait, h):
    jr, pr = robots(robot)
    jc = J.OracleController(jr, J.OracleConfig(horizon=h), J.OracleGait.by_name(gait))
    pc = P.OracleController(pr, P.OracleConfig(horizon=h, device=CPU),
                            P.OracleGait.by_name(gait, CPU))
    for tick in range(200):
        obs = synthetic_obs(tick)
        want = jc.step(obs, [1.2, 0.0, 0.0], 0.0, tick)
        got = pc.step(obs, [1.2, 0.0, 0.0], 0.0, tick)
        close(got["forces"], want["forces"], LOCKSTEP_BAR)
        close(got["torques"], want["torques"], LOCKSTEP_BAR)
        np.testing.assert_array_equal(got["swing_states"].numpy(), want["swing_states"])
        close(got["pos_targets"], want["pos_targets"], LOCKSTEP_BAR)
        close(got["vel_targets"], want["vel_targets"], LOCKSTEP_BAR)
        assert (pc.last_kkt is None) == (jc.last_kkt is None), tick
        if jc.last_kkt is not None:
            np.testing.assert_allclose(pc.last_kkt.numpy(), np.array(jc.last_kkt),
                                       rtol=0, atol=1e-12)
        np.testing.assert_array_equal(pc.is_first_swing, jc.is_first_swing)
        close(pc.remaining, jc.remaining)


def test_controller_holds_forces_on_a_failed_solve(monkeypatch):
    """A solve that raises leaves the previous forces applied, as npref's
    ``except LinAlgError: pass`` does."""
    pc = P.OracleController(P.oracle_aliengo(CPU), P.OracleConfig(horizon=10, device=CPU),
                            P.OracleGait.trotting10(CPU))
    first = pc.step(synthetic_obs(0), [1.2, 0.0, 0.0], 0.0, 0)["forces"]

    def fail(*args, **kwargs):
        raise torch.linalg.LinAlgError("not SPD")

    monkeypatch.setattr(P, "solve_qp_kkt", fail)
    held = pc.step(synthetic_obs(20), [1.2, 0.0, 0.0], 0.0, 20)["forces"]
    assert torch.equal(held, first) and bool(held.abs().sum() > 0)


# ---------------------------------------------------------------- C++ oracle


def test_cpp_source_is_the_reference_copy():
    with open(os.path.join(REPO, "native", "qp_oracle.cc"), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "pympc_quadruped_tpu_torch", "csrc", "qp_oracle.cc"), "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("tick", H10_TICKS)
def test_cpp_oracle_matches_python_oracle(tick):
    """tests/test_cpp_oracle.py's cross-certification against the port's
    npref, and bit for bit JAX's C++ oracle on the same instance."""
    H, g, table = h10(tick)
    U_py, kkt_py = P.solve_qp_kkt(H, g, 0.7, 500.0, table, device=CPU)
    assert float(kkt_py.max()) < 1e-7
    U_cc, kkt_cc = pcpp.solve_qp(H, g, table)
    assert U_cc.dtype == torch.float64 and U_cc.device.type == "cpu"
    assert float(kkt_cc.max()) < 1e-7, kkt_cc
    mv = np.repeat(table, 3)
    err = np.max(np.abs((U_cc.numpy() - U_py.numpy()) * mv) / (1.0 + np.abs(U_py.numpy() * mv)))
    assert err < 1e-6, err
    U_j, kkt_j = jcpp.solve_qp(H, g, table)
    np.testing.assert_array_equal(U_cc.numpy(), U_j)
    np.testing.assert_array_equal(kkt_cc.numpy(), kkt_j)


def test_cpp_oracle_swing_forces_zero():
    H, g, table = h10(100)
    U_cc, _ = pcpp.solve_qp(torch.tensor(H), torch.tensor(g), torch.tensor(table))
    mv = np.repeat(table, 3)
    np.testing.assert_allclose(U_cc.numpy() * (1 - mv), 0.0, atol=1e-12)


def test_cpp_oracle_respects_cone():
    H, g, table = h10(340)
    Ub = pcpp.solve_qp(H, g, table)[0].numpy().reshape(-1, 3)
    mu = 0.7
    for b in np.flatnonzero(table > 0.5):
        fx, fy, fz = Ub[b]
        assert -1e-8 <= fz <= 500.0 + 1e-8
        assert abs(fx) <= mu * fz + 1e-8
        assert abs(fy) <= mu * fz + 1e-8


def test_cpp_oracle_raises_on_an_indefinite_problem():
    H, g, table = h10(0)
    with pytest.raises(torch.linalg.LinAlgError):
        pcpp.solve_qp(-H, g, table)
