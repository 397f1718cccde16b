"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false: a CUDA kernel has no
CPU interpret mode (its arithmetic is checked on the CPU by
tests/test_torch_riccati.py and tests/test_torch_admm.py through the host
builds).  This file imports no JAX, because the machine with the card has
none.  tests/conftest.py does import JAX, so on that machine run it as

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from chip_smoke import (B_MAIN, CONE_SHARE, INV_RATIO_BAR, PARITY_COST_BAR, PARITY_GRF_BAR,
                        closed_loop_setup, condensed_problem, cone_violation, engine_inputs,
                        f64_cost,
                        fullorder_graph_and_eager, fullorder_setup, invariants_ok,
                        inverse_residual, parity_routes, qp_invariants, random_problem)
from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.control import refmpc
from pympc_quadruped_tpu_torch.env import fullorder, srb_env, terrain
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.loop import run_ticks
from pympc_quadruped_tpu_torch.models import Command, Gaits, a1, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, admm_fast, riccati, riccati_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 130])
def test_cuda_kernel_matches_plain(cuda_device, B):
    """Kernel vs plain version on the same CUDA tensors at h=16, with the
    on-TPU bars of tests/test_riccati_pallas.py:146-151 (first-step fz
    within 2%, U within 1 N); B=130 is a ragged batch."""
    mpc, robot, Ad, Bd, x_t, X_ref, table, *_ = random_problem(B, 16, seed=3, dev=cuda_device)
    before = riccati_cuda.LAUNCHES
    U_k = riccati.solve_batch(Ad, Bd, x_t, X_ref, table, robot.fz_max, mpc, backend="cuda")
    U_p = riccati.solve_batch(Ad, Bd, x_t, X_ref, table, robot.fz_max, mpc, backend="torch")
    torch.cuda.synchronize()
    assert riccati_cuda.LAUNCHES == before + 1
    assert bool(torch.isfinite(U_k).all())
    fz_k, fz_p = U_k.reshape(B, 16, 4, 3)[:, 0, :, 2], U_p.reshape(B, 16, 4, 3)[:, 0, :, 2]
    assert float(((fz_k - fz_p).abs() / fz_p.abs().clamp(min=20.0)).max()) < 0.02
    assert float((U_k - U_p).abs().max()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("h", [3, 10])
@pytest.mark.parametrize("B", [1, 33])
def test_cuda_kernel_matches_plain_short_horizons(cuda_device, h, B):
    """Kernel vs plain version at other horizons and at batches that leave
    half a warp (B=1) and a block partly idle (B=33), with the same bars."""
    mpc, robot, Ad, Bd, x_t, X_ref, table, *_ = random_problem(B, h, seed=7, dev=cuda_device)
    U_k = riccati.solve_batch(Ad, Bd, x_t, X_ref, table, robot.fz_max, mpc, backend="cuda")
    U_p = riccati.solve_batch(Ad, Bd, x_t, X_ref, table, robot.fz_max, mpc, backend="torch")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(U_k).all())
    fz_k, fz_p = U_k.reshape(B, h, 4, 3)[:, 0, :, 2], U_p.reshape(B, h, 4, 3)[:, 0, :, 2]
    assert float(((fz_k - fz_p).abs() / fz_p.abs().clamp(min=20.0)).max()) < 0.02
    assert float((U_k - U_p).abs().max()) < 1.0


@pytest.mark.cuda
def test_cuda_closed_loop_goes_through_the_kernel(cuda_device):
    """40 ticks of the h=16 trot at B=64 on the card with the Riccati
    solver: one launch per solve tick, finite torques, forces on the stance
    legs only."""
    _check_short_loop(cuda_device, "riccati", {"riccati_admm": 2})


def _check_short_loop(dev, solver, expected):
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(dev, B=64)
    before = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    carry, state, out = run_ticks(robot, mpc, gait, cmd, carry, state, 0, 40, solver)
    torch.cuda.synchronize()
    after = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    assert {k: after[k] - before[k] for k in after} == {k: expected.get(k, 0) for k in after}
    assert bool(torch.isfinite(out.torques).all())
    swinging = (out.swing_states != 0).repeat_interleave(3, dim=-1)
    assert float(out.contact_forces[swinging].abs().max()) == 0.0
    assert np.isfinite(state.pos.cpu().numpy()).all()


@pytest.mark.cuda
def test_cuda_condensed_closed_loop_goes_through_the_kernels(cuda_device):
    """40 ticks with the default solver: the invert and iterate kernels
    launch once per solve tick each, nothing else launches."""
    _check_short_loop(cuda_device, "admm_fast", {"invert_spd": 2, "iterate": 2})


@pytest.mark.cuda
@pytest.mark.parametrize("B,h", [(256, 16), (130, 16), (33, 17), (130, 7), (33, 20)])
def test_cuda_condensed_kernels_match_plain(cuda_device, B, h):
    """Kernels 2-5 against their plain versions with the bars of
    chip_smoke.py phase 5: the invert kernel's f64 residual within 2x of
    spd_inverse's; each backend's solution against jnp with the JAX bench's
    batch kernel gate (f64 cost excess, cone rows, predicted CoM
    trajectory), cold and warm-started.  At h=16 the inverting kernels
    keep their buffers in shared memory; at h=17 they do not fit and lie
    in the device-memory workspace.  The iterate kernel holds Kinv in
    registers to h=16 (at h=7 most of the tile masked, over a ragged
    batch), in shared memory at h=17 and reads it from device memory at
    h=20."""
    p = condensed_problem(B, 11, cuda_device, h=h)
    args = (p.H, p.g, p.table, p.robot.fz_max, p.mpc)
    K = admm_fast.setup(*args, admm_fast.AdmmFastConfig(), invert=False).K
    r_k = float(inverse_residual(admm_cuda.invert_spd(K), K).max())
    r_p = float(inverse_residual(admm_fast.spd_inverse(K), K).max())
    assert r_k <= INV_RATIO_BAR * r_p, (r_k, r_p)
    for w, cfg in ((None, admm_fast.AdmmFastConfig()),
                   (p.warm, admm_fast.AdmmFastConfig.inloop())):
        U_p = admm_fast.solve_batch(*args, cfg, backend="jnp", warm=w)
        for backend in ("pallas", "pallas_split", "pallas_fused", "pallas_full"):
            U_k = admm_fast.solve_batch(*args, cfg, backend=backend, warm=w)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(U_k).all()), backend
            inv = qp_invariants(p, U_k, U_p)
            assert invariants_ok(inv, float(p.robot.fz_max.max())), (backend, inv)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h", [(256, 16), (130, 16), (256, 10)])
def test_cuda_fused_kernel_matches_split_bitwise(cuda_device, B, h):
    """The fused kernel runs the invert kernel's inverse and sweeps on Kinv
    in registers in the iterate kernel's summation order, so on the card
    its scaled (x, y) equal the split path's (invert_spd, then iterate) bit
    for bit, cold and warm-started: every register tile full (h=16), over a
    ragged batch, and at h=10 (n=120, six warps idle)."""
    p = condensed_problem(B, 11, cuda_device, h=h)
    args = (p.H, p.g, p.table, p.robot.fz_max, p.mpc)
    P0 = admm_fast.cone_pattern(p.mpc.friction_coef, h)
    for w, cfg in ((None, admm_fast.AdmmFastConfig()),
                   (p.warm, admm_fast.AdmmFastConfig.inloop())):
        kkt = admm_fast.setup(*args, cfg, invert=False)
        init = None if w is None else admm_fast.warm_init(kkt, P0, w)
        before = dict(admm_cuda.LAUNCHES)
        fused = admm_cuda.iterate_fused(kkt, P0, cfg, init)
        split = admm_cuda.invert_iterate(kkt, P0, cfg, init)
        torch.cuda.synchronize()
        assert {k: admm_cuda.LAUNCHES[k] - before[k] for k in before} == {
            "invert_spd": 1, "iterate": 1, "iterate_fused": 1, "solve_full": 0}
        assert bool(torch.isfinite(fused[0]).all() and torch.isfinite(fused[1]).all())
        for a, b in zip(fused, split):
            assert torch.equal(a, b)


def _assert_bitwise(a, b):
    tree.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["riccati", "admm_fast"])
def test_cuda_graph_rollout_equals_eager_run_ticks(cuda_device, solver):
    """60 ticks at B=33: ``rollout`` (non-solve ticks replayed from its
    captured graph) bit for bit the eager ``loop.run_ticks``, with the
    solver's kernels launched once per solve tick, by the eager solve
    ticks only."""
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(cuda_device, B=33)
    carry_e, state_e, _ = run_ticks(robot, mpc, gait, cmd, carry, state, 0, 60, solver)
    before = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    (state_g, carry_g), metrics = srb_env.rollout(robot, mpc, gait, cmd, 60,
                                                  init_state=state, solver=solver)
    torch.cuda.synchronize()
    after = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate")
    assert {k: after[k] - before[k] for k in after} == {k: 3 * (k in on_path) for k in after}
    _assert_bitwise((state_g, carry_g), (state_e, carry_e))
    assert not bool(metrics["diverged"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["truth", "estimator"])
def test_cuda_chunked_rollout_equals_monolithic(cuda_device, mode):
    """2 x 50 ticks (tick0, carry_in, return_full_carry) == 100 ticks on the
    card, bit for bit, noise included."""
    mpc, robot, gait, cmd, _, state = closed_loop_setup(cuda_device, B=33)
    kw = dict(solver="riccati", init_state=state, return_full_carry=True, cmd_ramp_ticks=30)
    if mode == "estimator":
        kw.update(estimator=kf.KfParams.default(device=cuda_device), key=7)
    (s_m, c_m), m_m = srb_env.rollout(robot, mpc, gait, cmd, 100, **kw)
    (s_1, c_1), m_1 = srb_env.rollout(robot, mpc, gait, cmd, 50, **kw)
    kw["init_state"] = s_1
    (s_2, c_2), m_2 = srb_env.rollout(robot, mpc, gait, cmd, 50, carry_in=c_1, tick0=50, **kw)
    _assert_bitwise((s_m, c_m), (s_2, c_2))
    for k in m_m:
        _assert_bitwise(m_m[k], torch.cat([m_1[k], m_2[k]]))


@pytest.mark.cuda
@pytest.mark.parametrize("contact_source", ["plan", "measured"])
def test_cuda_estimator_rollout_graph_equals_eager(cuda_device, contact_source):
    """The estimator mode with sensor noise (A1, h=10, TROTTING10, 0.8 m/s,
    command ramp), 60 ticks at B=33: the replayed rollout against the same
    loop's tick function run eagerly on every tick, bit for bit."""
    B = 33
    mpc = default_mpc_params(10, device=cuda_device)
    robot = tree.tile(a1(device=cuda_device), B)
    gait = tree.tile(Gaits.trotting10(device=cuda_device), B)
    cmd = tree.tile(Command.trot_forward(0.8, device=cuda_device), B)
    kw = dict(estimator=kf.KfParams.default(device=cuda_device),
              sensor_noise=srb_env.SensorNoise.default(cuda_device), key=3,
              cmd_ramp_ticks=300, contact_source=contact_source)
    (s_g, c_g), m_g = srb_env.rollout(robot, mpc, gait, cmd, 60, return_full_carry=True, **kw)
    eager = srb_env.RolloutLoop(robot, mpc, gait, cmd, 60, **kw)
    for tick in range(60):
        eager._tick(eager.buf, solve=ctrl.is_solve_tick(mpc, tick))
    (s_e, c_e), m_e = eager.result(return_full_carry=True)
    _assert_bitwise((s_g, c_g), (s_e, c_e))
    for k in m_g:
        _assert_bitwise(m_g[k], m_e[k])
    assert float(m_g["est_pos_err"].max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("part,solver", [("11a", "riccati"), ("11b", "admm_fast")])
def test_cuda_fullorder_graph_equals_eager(cuda_device, part, solver):
    """100 ticks of the full-order trot at B=33 (chip_smoke phase 11's
    configurations): the rollout through its graph bit for bit the eager
    tick, with one launch of each solver kernel per solve tick."""
    mpc, robot, gait, cmd, state0 = fullorder_setup(cuda_device, part, 33)
    before = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    (g, m_g), (e, m_e) = fullorder_graph_and_eager((robot, mpc, gait, cmd), 100,
                                                   state0=state0, solver=solver)
    torch.cuda.synchronize()
    after = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate")
    assert {k: after[k] - before[k] for k in after} == {k: 10 * (k in on_path) for k in after}
    _assert_bitwise(g, e)
    for k in m_g:
        _assert_bitwise(m_g[k], m_e[k])
    assert not bool(m_g["diverged"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["truth", "estimator"])
def test_cuda_fullorder_chunked_equals_monolithic(cuda_device, mode):
    """2 x 60 ticks (state0, carry0 = the full carry, tick0) == 120 ticks on
    the card, bit for bit, sensor noise included."""
    mpc, robot, gait, cmd, state0 = fullorder_setup(cuda_device, "11a", 33)
    kw = dict(solver="riccati", return_full_carry=True)
    if mode == "estimator":
        kw.update(estimator=kf.KfParams.default(device=cuda_device), key=7)
    (s_m, c_m), m_m = fullorder.rollout(robot, mpc, gait, cmd, 120, state0=state0, **kw)
    (s_1, c_1), m_1 = fullorder.rollout(robot, mpc, gait, cmd, 60, state0=state0, **kw)
    (s_2, c_2), m_2 = fullorder.rollout(robot, mpc, gait, cmd, 60, state0=s_1, carry0=c_1,
                                        tick0=60, **kw)
    _assert_bitwise((s_m, c_m), (s_2, c_2))
    for k in m_m:
        _assert_bitwise(m_m[k], torch.cat([m_1[k], m_2[k]]))


@pytest.mark.cuda
def test_cuda_fullorder_estimator_terrain_substeps_graph_equals_eager(cuda_device):
    """The estimator on noisy sensors, rough terrain, ``substeps=2``,
    auto-reset and a command ramp (chip_smoke phase 11c) at B=33, 60 ticks:
    the graph's ticks bit for bit the eager tick's."""
    B = 33
    mpc = default_mpc_params(10, device=cuda_device)
    robot = tree.tile(aliengo(device=cuda_device), B)
    gait = tree.tile(Gaits.trotting10(device=cuda_device), B)
    cmd = tree.tile(Command.trot_forward(0.8, device=cuda_device), B)
    terr = tree.tile(terrain.random_rough(torch.Generator(device=cuda_device).manual_seed(3),
                                          amplitude=0.02, device=cuda_device), B)
    (g, m_g), (e, m_e) = fullorder_graph_and_eager(
        (robot, mpc, gait, cmd), 60, terrain=terr, estimator=kf.KfParams.default(
            device=cuda_device), sensor_noise=srb_env.SensorNoise.default(cuda_device), key=3,
        substeps=2, auto_reset=True, cmd_ramp_ticks=400)
    _assert_bitwise(g, e)
    for k in m_g:
        _assert_bitwise(m_g[k], m_e[k])
    assert float(m_g["est_pos_err"].max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["admm_ref", "ipm", "parity"])
def test_cuda_parity_routes_match_cpu(cuda_device, route):
    """chip_smoke phase 12a's routes on 16 of its scenarios (h=16) on the
    card against the same calls on the CPU: finite, swing forces exactly 0,
    cone rows within 1e-3 fz_max; the parity route's first-step GRFs within
    the phase's bar of the CPU's in every scenario, the f32 routes' f64
    costs within the phase's cost bar of the CPU's."""
    B = 16
    mpc, robot, inputs = engine_inputs(cuda_device, B)
    U = parity_routes(mpc, robot, inputs)[route]()
    cpu = torch.device("cpu")
    mpc_c, robot_c = tree.to(mpc, cpu), tree.tile(aliengo(device=cpu), B)
    inputs_c = tuple(t.cpu() for t in inputs)
    U_c = parity_routes(mpc_c, robot_c, inputs_c)[route]()
    U = U.cpu()
    assert bool(torch.isfinite(U).all())
    mv = inputs_c[4].repeat_interleave(3, dim=-1)
    assert bool((U[mv == 0] == 0).all())
    assert float(cone_violation(U, inputs_c[4], robot_c.fz_max, mpc_c).max()) \
        <= CONE_SHARE * float(robot_c.fz_max.max())
    if route == "parity":
        first = ((U - U_c).abs() / (1.0 + U_c.abs()))[:, :12].amax(-1)
        assert float(first.max()) < PARITY_GRF_BAR
        return
    H, g, _ = refmpc.build_qp(robot_c, mpc_c, *inputs_c)
    c, c_c = (f64_cost(H.double(), g.double(), V) for V in (U, U_c))
    assert float(((c - c_c).abs() / (c_c.abs() + 1.0)).max()) < PARITY_COST_BAR


#: Phase 12a scenarios whose parity solution once moved with the batch it was
#: solved in on the card (198: alone 8.7e-3 from its B=4096 answer) or sat
#: far from the CPU's (530, 941, 3025), while the parity solve ran its first
#: iterations in float32 (tools/parity_batch_probe.jsonl); and scenario 0.
PARITY_PROBE_SCENARIOS = (0, 198, 530, 941, 3025)


@pytest.mark.cuda
def test_cuda_parity_independent_of_batch(cuda_device):
    """The parity pipeline on the card solves each of PARITY_PROBE_SCENARIOS
    alone (B=1), together, and inside phase 12a's B=4096 batch; the
    first-step GRFs agree within tests/test_qp.py's 1e-3 of (1 + |U|), and
    with the same scenario solved alone on the CPU."""
    mpc, robot, inputs = engine_inputs(cuda_device, B_MAIN)
    U_all = parity_routes(mpc, robot, inputs)["parity"]()
    idx = torch.tensor(PARITY_PROBE_SCENARIOS, device=cuda_device)
    sub = tuple(t[idx] for t in inputs)
    U_sub = parity_routes(mpc, tree.tile(aliengo(device=cuda_device), len(idx)), sub)["parity"]()
    robot_1 = tree.tile(aliengo(device=cuda_device), 1)
    U_one = torch.cat([parity_routes(mpc, robot_1, tuple(t[i:i + 1] for t in sub))["parity"]()
                       for i in range(len(idx))])
    cpu = torch.device("cpu")
    mpc_c, robot_c = tree.to(mpc, cpu), tree.tile(aliengo(device=cpu), 1)
    U_cpu = torch.cat([parity_routes(mpc_c, robot_c, tuple(t[i:i + 1].cpu() for t in sub))
                       ["parity"]() for i in range(len(idx))])
    rel = lambda a, b: float(((a.cpu().double() - b.cpu().double()).abs()
                              / (1.0 + b.cpu().double().abs()))[:, :12].max())
    assert bool(torch.isfinite(U_all).all())
    assert rel(U_all[idx], U_one) < 1e-3
    assert rel(U_sub, U_one) < 1e-3
    assert rel(U_one, U_cpu) < 1e-3
