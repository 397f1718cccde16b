"""The controller's tick kernels (``csrc/ctrl_tick.cuh``) on the CPU, through
their host build (``csrc/ctrl_tick_host.cpp``), against the plain PyTorch
functions they mirror: ``srb_env.observe``, ``controller._pre_solve`` and
``controller._post_solve``.

Scenarios are drawn per row from a seed: mass, inertia and hip offsets
randomised, the command's speed and yaw rate, a tilted, moving rigid body
with moving feet, and swing and MPC carries with both values of every flag.
Gaits TROTTING16 and jumping16 (its flight steps) at h=16, pacing10 and
bounding8 at h=10, every tick of a whole gait cycle, the tick as a Python
int and as a 0-d int32 tensor.

Tolerance, from what the kernels read against the plain functions
(PyTorch's kernels reassociate sums and round their transcendentals
differently, and the card's build contracts products and sums into FMAs):
each float output within ``ULPS`` = 16 float32 ulps of the largest
magnitude of its field, about three times the worst measured (5.5 ulps here,
torques; 5.8 on an H100 at B=4096, the swing velocity targets); the swing
phases, the stance table, the swing latches' remaining time and the flags,
which take no product, bit for bit.  In a 200-tick closed loop the kernels
read, at every tick, the tensors the plain functions read, under the same
bounds (worst 4.1 ulps), the torques' ulps taken of the largest magnitude
of the operands behind a torque (chip_smoke's ``torque_scale``): in the
full-order loop on a card a swing leg's PD terms cancel to a torque of ~2.3 N m, and
the card's error there was 38.5 ulps of the torque field (H100), 2.2
ulps of its operands (worst of any field on the card 6.8, the swing
velocity targets).  A closed loop run through the host build stays
within ``LOOP_REL`` = 2e-3 of the plain loop, relative to each leaf's
largest magnitude (Riccati; worst 1.9e-4 after 200 ticks, the pitch
integrator).  With ``admm_fast`` a free-running loop is no yardstick: its
float32 inverse of a kappa ~1e5 matrix turns ulps into 2-70% of the warm
start's duals within 200 ticks (tests/test_torch_controller.py), so those
loops are held in lockstep only.
"""
import dataclasses

import pytest
import torch

from chip_smoke import (CTRL_EXACT as EXACT, CTRL_ULPS as ULPS, closed_loop_setup,
                        fullorder_setup, shadow_ctrl_kernels)
from pympc_quadruped_tpu_torch import _build, tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.control import ctrl_cuda
from pympc_quadruped_tpu_torch.env import fullorder, srb_env
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params

torch.set_num_threads(1)

EPS = torch.finfo(torch.float32).eps
LOOP_REL = 2e-3
GAITS = {"trotting16": 16, "jumping16": 16, "pacing10": 10, "bounding8": 10}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build of csrc/ctrl_tick.cuh."""
    return _build.build_host("ctrl_tick_host.cpp", tmp_path_factory.mktemp("ctrl_tick_host"))


def _scenario(B, gait_name, seed, adaptive=False):
    """(robot, mpc, gait, cmd, controller carry, SRB state) of B rows drawn
    from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=g)
    randn = lambda *s: torch.randn(s, generator=g)
    h = GAITS[gait_name]
    mpc = dataclasses.replace(default_mpc_params(h, device="cpu"),
                              ground_adaptive_height=adaptive)
    robot = tree.tile(aliengo(device="cpu"), B)
    robot = dataclasses.replace(
        robot, mass=robot.mass * torch.exp(0.2 * (2 * rand(B) - 1)),
        inertia=robot.inertia * torch.exp(0.2 * (2 * rand(B) - 1))[:, None, None],
        hip_offset=robot.hip_offset + 0.01 * randn(B, 4, 3))
    gait = tree.tile(Gaits.by_name(gait_name, device="cpu"), B)
    cmd = Command(vel_base_des=torch.stack([0.4 + 0.8 * rand(B), 0.1 * randn(B),
                                            torch.zeros(B)], -1),
                  yaw_turn_rate=0.3 * randn(B))
    carry = tree.tile(ctrl.init_carry(h, device="cpu"), B)
    carry = ctrl.ControllerCarry(
        mpc=dataclasses.replace(carry.mpc, xpos_des=0.1 * randn(B), ypos_des=0.1 * randn(B),
                                yaw_des=0.1 * randn(B), first_run=rand(B) < 0.5),
        swing=dataclasses.replace(carry.swing, is_first_swing=rand(B, 4) < 0.5,
                                  remaining_swing_time=0.2 * rand(B, 4),
                                  footpos_init=0.3 * randn(B, 4, 3),
                                  footpos_final=0.3 * randn(B, 4, 3)))
    s = srb_env.default_init_state(robot)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0]) + 0.08 * randn(B, 4)
    state = dataclasses.replace(
        s, pos=s.pos + 0.02 * randn(B, 3), quat=quat / quat.norm(dim=-1, keepdim=True),
        vel=s.vel + 0.3 * randn(B, 3), omega_body=0.3 * randn(B, 3),
        foot_pos=s.foot_pos + 0.02 * randn(B, 4, 3), foot_vel=0.2 * randn(B, 4, 3))
    return robot, mpc, gait, cmd, carry, state


def _assert_close(name, got, want):
    if got.dtype == torch.bool or name.rsplit("/", 1)[-1] in EXACT:
        assert torch.equal(got, want), name
        return
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= ULPS * EPS * max(scale, 1e-6), f"{name}: {err:.3e} over {scale:.3e}"


def _assert_tree(got, want):
    g, w = tree.flatten(got), tree.flatten(want)
    assert g.keys() == w.keys()
    for k in w:
        _assert_close(k, g[k], w[k])


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_observe_host_build_matches_plain(host, B, seed):
    robot, *_, state = _scenario(B, "trotting16", seed)
    _assert_tree(ctrl_cuda.srb_observe(robot, state, lib=host), srb_env.observe(robot, state))


def _ticks(mpc, gait):
    """Every tick of one gait cycle, from a start that is not the first."""
    period = mpc.iterations_between_mpc * int(gait.num_segments[0])
    return range(3 * period, 4 * period)


@pytest.mark.parametrize("tick_kind", ["int", "tensor"])
@pytest.mark.parametrize("gait_name", list(GAITS))
@pytest.mark.parametrize("B", [1, 7, 64])
def test_pre_host_build_matches_plain_over_a_gait_cycle(host, B, gait_name, tick_kind):
    robot, mpc, gait, cmd, carry, state = _scenario(B, gait_name, seed=B)
    obs = srb_env.observe(robot, state)
    switches = 0
    prev = None
    for t in _ticks(mpc, gait):
        tick = t if tick_kind == "int" else torch.tensor(t, dtype=torch.int32)
        want = ctrl._pre_solve(robot, mpc, gait, cmd, carry, obs, tick)
        got = ctrl_cuda.ctrl_pre(robot, mpc, gait, cmd, carry.mpc, obs, tick, lib=host)
        names = ("kin", "swing_states", "table", "x_t", "mpc", "vel_des_world")
        _assert_tree(dict(zip(names, got)), dict(zip(names, want)))
        stance = want[1] == 0
        switches += 0 if prev is None else int((stance != prev).sum())
        prev = stance
    assert switches > 0


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("gait_name", list(GAITS))
@pytest.mark.parametrize("B", [1, 7, 64])
def test_post_host_build_matches_plain_over_a_gait_cycle(host, B, gait_name, adaptive):
    """The swing carry advances along a whole cycle (the plain one, fed to
    both), so every leg's first-swing latch sets and clears."""
    robot, mpc, gait, cmd, carry, state = _scenario(B, gait_name, seed=10 + B, adaptive=adaptive)
    obs = srb_env.observe(robot, state)
    forces = 40.0 * torch.randn(B, 12, generator=torch.Generator().manual_seed(B))
    flips = torch.zeros(B, 4, dtype=torch.int64)
    for t in _ticks(mpc, gait):
        ks, swing_states, _, _, mpc_carry, _ = ctrl._pre_solve(robot, mpc, gait, cmd, carry,
                                                               obs, t)
        want_carry, want = ctrl._post_solve(robot, mpc, gait, cmd, carry, ks, swing_states,
                                            mpc_carry, forces)
        got = ctrl_cuda.ctrl_post(robot, mpc, gait, cmd, ks, carry.swing, swing_states, forces,
                                  lib=host)
        _assert_tree(dict(zip(("swing", "pos_targets", "vel_targets", "torques"), got)),
                     {"swing": want_carry.swing, "pos_targets": want.pos_targets,
                      "vel_targets": want.vel_targets, "torques": want.torques})
        flips += want_carry.swing.is_first_swing != carry.swing.is_first_swing
        carry = want_carry
    assert bool((flips.sum(dim=0) > 0).all())


def test_row_views_read_in_place_and_expanded_views_raise(host):
    """An observation whose fields are columns of wider tensors (the
    full-order plant's and the estimator's) gives the same answer as its
    contiguous copy; an expanded parameter and a wrong dtype raise."""
    B = 7
    robot, mpc, gait, cmd, carry, state = _scenario(B, "trotting16", seed=3)
    obs = srb_env.observe(robot, state)
    wide = torch.cat([obs.ang_vel_base, obs.qdot, obs.pos_base, torch.zeros(B, 5)], dim=-1)
    strided = dataclasses.replace(obs, ang_vel_base=wide[:, 0:3], qdot=wide[:, 3:15],
                                  pos_base=wide[:, 15:18])
    assert not strided.qdot.is_contiguous()
    a = ctrl_cuda.ctrl_pre(robot, mpc, gait, cmd, carry.mpc, strided, 5, lib=host)
    b = ctrl_cuda.ctrl_pre(robot, mpc, gait, cmd, carry.mpc, obs, 5, lib=host)
    names = ("kin", "swing_states", "table", "x_t", "mpc", "vel_des_world")
    for k, v in tree.flatten(dict(zip(names, b))).items():
        assert torch.equal(tree.flatten(dict(zip(names, a)))[k], v), k
    shared = dataclasses.replace(robot, hip_offset=robot.hip_offset[:1].expand(B, 4, 3))
    with pytest.raises(ValueError, match="expanded"):
        ctrl_cuda.ctrl_pre(shared, mpc, gait, cmd, carry.mpc, obs, 5, lib=host)
    wide_gait = dataclasses.replace(gait, num_segments=gait.num_segments.long())
    with pytest.raises(TypeError, match="int32"):
        ctrl_cuda.ctrl_pre(robot, mpc, wide_gait, cmd, carry.mpc, obs, 5, lib=host)


def test_engagement_rule():
    """The kernels run for float32 CUDA operands only: CPU tensors and
    float64 take the plain functions, and without a ``lib`` the wrapper
    refuses a CPU tensor."""
    robot, mpc, gait, cmd, carry, state = _scenario(3, "trotting16", seed=4)
    assert not ctrl_cuda.engages(robot, state)
    assert not ctrl_cuda.engages(robot, mpc, gait, cmd, carry, 0)
    assert set(ctrl_cuda.LAUNCHES) == {"srb_observe", "ctrl_pre", "ctrl_post"}
    with pytest.raises(ValueError, match="CUDA"):
        ctrl_cuda.srb_observe(robot, state)


CLOSED_LOOPS = [("srb", "riccati"), ("srb", "admm_fast"), ("fullorder", "admm_fast")]


def closed_loop(plant, solver, dev, B, ticks):
    """chip_smoke's trot loop on ``dev``: the SRB one at h=16 (jittered
    starts) or phase 11b's full-order one at h=10, built (and on a card
    captured) for ``ticks`` ticks."""
    if plant == "srb":
        mpc, robot, gait, cmd, _, state = closed_loop_setup(dev, B)
        return srb_env.RolloutLoop(robot, mpc, gait, cmd, ticks, init_state=state,
                                   solver=solver)
    mpc, robot, gait, cmd, state0 = fullorder_setup(dev, "11b", B)
    return fullorder.RolloutLoop(robot, mpc, gait, cmd, ticks, state0=state0, solver=solver)


def shadow_kernels(monkeypatch, lib=None) -> dict:
    """chip_smoke's :func:`shadow_ctrl_kernels` under ``monkeypatch``."""
    return shadow_ctrl_kernels(monkeypatch.setattr, lib)


def assert_lockstep(worst: dict, plant: str) -> None:
    kernels = {k.split("/")[0] for k in worst}
    assert kernels == {"ctrl_pre", "ctrl_post"} | ({"srb_observe"} if plant == "srb" else set())
    for k, (err, bound) in worst.items():
        assert float(err) <= bound, f"{k}: {float(err):.3g} > {bound}"


@pytest.mark.parametrize("plant,solver", CLOSED_LOOPS)
def test_closed_loop_kernels_in_lockstep_with_the_plain_loop(host, monkeypatch, plant, solver):
    """200 ticks of the plain closed loop (B=16), each tick's kernels
    (host build) reading the tensors the plain functions read: every output
    within ``ULPS``, the exact fields equal, over every tick."""
    loop = closed_loop(plant, solver, torch.device("cpu"), 16, 200)
    worst = shadow_kernels(monkeypatch, lib=host)
    for _ in range(200):
        loop.step()
    assert not bool(loop.result()[1]["diverged"].any())
    assert_lockstep(worst, plant)


def _run(loop, ticks):
    for _ in range(ticks):
        loop.step()
    return loop.result(return_full_carry=True)


def assert_loops_close(got, want) -> None:
    """Every float leaf within ``LOOP_REL`` of its largest magnitude, the
    flags and diverged rows equal."""
    g = tree.flatten(got)
    for k, w in tree.flatten(want).items():
        if w.dtype == torch.bool:
            assert torch.equal(g[k], w), k
        else:
            scale = max(float(w.abs().max()), 1e-6)
            assert float((g[k] - w).abs().max()) <= LOOP_REL * scale, k


def test_closed_loop_through_the_host_build_holds_the_plain_loop(host, monkeypatch):
    """200 ticks of the SRB trot (B=16, h=16, riccati), its controller
    once through the host build of the three kernels and once plain: the
    state, carry and metric rows stay within ``LOOP_REL``."""
    plain = _run(closed_loop("srb", "riccati", torch.device("cpu"), 16, 200), 200)
    calls = {"n": 0}

    def library(device, lib):
        calls["n"] += 1
        return host, None

    monkeypatch.setattr(ctrl_cuda, "engages", lambda *a: True)
    monkeypatch.setattr(ctrl_cuda, "_library", library)
    kernels = _run(closed_loop("srb", "riccati", torch.device("cpu"), 16, 200), 200)
    assert calls["n"] == 3 * 200
    assert not bool(plain[1]["diverged"].any())
    assert_loops_close(kernels, plain)
