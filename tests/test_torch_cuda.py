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

from chip_smoke import (B_MAIN, CONE_SHARE, INV_RATIO_BAR, NAN_BACKENDS, PARITY_COST_BAR,
                        PARITY_GRF_BAR, closed_loop_setup, condense_nan_isolation, condense_ok,
                        condense_operands, condense_report, condensed_problem, cone_violation,
                        engine_inputs, f64_cost, fullorder_graph_and_eager, fullorder_setup,
                        invariants_ok, inverse_residual, nan_isolation, parity_routes,
                        phase_oracle_certificate, plain_condense, qp_invariants, random_problem,
                        trot_qp_inputs)
from test_torch_ctrl_tick import (CLOSED_LOOPS, assert_lockstep, assert_loops_close,
                                  closed_loop, shadow_kernels)

from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.control import ctrl_cuda
from pympc_quadruped_tpu_torch.control import refmpc
from pympc_quadruped_tpu_torch.env import fullorder, graph_loop, srb_env, terrain
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.loop import run_ticks
from pympc_quadruped_tpu_torch.models import Command, Gaits, a1, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.ops import srb
from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, admm_fast, riccati, riccati_cuda
from pympc_quadruped_tpu_torch.utils import profiling


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
    solver: one launch per solve tick and none of any other kernel (the
    condensing kernel included), finite torques, forces on the stance legs
    only."""
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
    """40 ticks with the default solver: the condensing, invert and iterate
    kernels launch once per solve tick each, nothing else launches."""
    _check_short_loop(cuda_device, "admm_fast", {"invert_spd": 2, "iterate": 2, "condense": 2})


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
@pytest.mark.parametrize("h", [16, 10])
def test_cuda_condense_kernel_matches_plain(cuda_device, h):
    """chip_smoke.py phase 5b at B=4096: the condensing kernel's masked (H,
    g) against the plain ``condense.condense`` + ``cones.mask_cost`` on the
    same CUDA tensors, per scenario max gap over max |ref| below
    CONDENSE_REL_BAR, H exactly symmetric, masked rows and columns exactly
    identity with g exactly 0 (swing legs, and one scenario in flight); and
    ``build_qp`` launches the kernel once a call, nothing else, and returns
    the kernel's operands bit for bit."""
    mpc, ops = condense_operands(B_MAIN, h, 19, cuda_device)
    H, g = admm_cuda.condense(*ops, mpc)
    r = condense_report(H, g, *plain_condense(mpc, *ops), ops[-1])
    assert condense_ok(r) and r["masked"] > 0, r
    del H, g
    (mpc, robot, x_t, yaw, feet, X_ref, table), _ = trot_qp_inputs(B_MAIN, 23, cuda_device, h)
    for _ in range(2):
        before = dict(admm_cuda.LAUNCHES)
        H, g, mv = refmpc.build_qp(robot, mpc, x_t, yaw, feet, X_ref, table)
        torch.cuda.synchronize()
        assert {k: admm_cuda.LAUNCHES[k] - before[k] for k in before} == {
            "invert_spd": 0, "iterate": 0, "iterate_fused": 0, "solve_full": 0, "condense": 1}
    Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
    H_k, g_k = admm_cuda.condense(Ad, Bd, x_t, X_ref, mv, mpc)
    assert torch.equal(H, H_k) and torch.equal(g, g_k)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 10])
def test_cuda_condense_nan_scenario_leaves_the_others_bitwise(cuda_device, h):
    """One NaN scenario (its x_t) of a B=4096 batch through the condensing
    kernel leaves every other scenario's H and g bit for bit the same, and
    its own g non-finite."""
    mpc, ops = condense_operands(B_MAIN, h, 29, cuda_device)
    r = condense_nan_isolation(mpc, ops)
    assert r["others_differ"] == 0 and not r["poisoned_finite"], r


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
            "invert_spd": 1, "iterate": 1, "iterate_fused": 1, "solve_full": 0, "condense": 0}
        assert bool(torch.isfinite(fused[0]).all() and torch.isfinite(fused[1]).all())
        for a, b in zip(fused, split):
            assert torch.equal(a, b)


def _assert_bitwise(a, b):
    tree.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)


_ON_PATH = {"riccati": ("riccati_admm",), "admm_fast": ("invert_spd", "iterate", "condense")}


def _loop_launches(solver, solves):
    """Each kernel's host launches by a loop built on the card and run for
    ``solves`` solve ticks: the solver's once a solve tick (the tape's eager
    solve); the condensing kernel, which builds the QP inside the tape's
    graphs, three times at the build (the tape's two warm-up ticks and its
    recording)."""
    out = {k: 0 for k in ("riccati_admm", *admm_cuda.LAUNCHES)}
    for k in _ON_PATH[solver]:
        out[k] = 3 if k == "condense" else solves
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["riccati", "admm_fast"])
def test_cuda_graph_rollout_equals_eager_run_ticks(cuda_device, solver):
    """60 ticks at B=33: ``rollout`` (non-solve ticks replayed from its
    captured graph, the solve ticks after the first from its tape around
    the eager solve) bit for bit the eager ``loop.run_ticks``, with the
    solver's kernels launched once per solve tick, by the eager solves
    only; the condensing kernel, part of the tape's graphs, launches from
    the host at the loop's build only."""
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(cuda_device, B=33)
    carry_e, state_e, _ = run_ticks(robot, mpc, gait, cmd, carry, state, 0, 60, solver)
    before = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    (state_g, carry_g), metrics = srb_env.rollout(robot, mpc, gait, cmd, 60,
                                                  init_state=state, solver=solver)
    torch.cuda.synchronize()
    after = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    assert {k: after[k] - before[k] for k in after} == _loop_launches(solver, 3)
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
    graph, built = _loop_launches(solver, 5), _loop_launches(solver, 0)
    eager = {k: built[k] + 5 * (k in _ON_PATH[solver]) for k in after}
    assert {k: after[k] - before[k] for k in after} == {k: graph[k] + eager[k] for k in after}
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


@pytest.mark.cuda
@pytest.mark.parametrize("backend", NAN_BACKENDS)
def test_cuda_nan_scenario_leaves_the_others_bitwise(cuda_device, backend):
    """chip_smoke.py phase 14d: one NaN scenario of a B=4096 batch, through
    each kernel backend, leaves every other scenario's solution bit for
    bit the same as without it."""
    r = nan_isolation(cuda_device, backend)
    assert r["others_differ"] == 0 and r["others_finite"], r


@pytest.mark.cuda
def test_cuda_oracle_certifies_the_main_path_qps(cuda_device):
    """chip_smoke.py phase 15a at B=64: the float64 oracle's condensing and
    QP solve on the card, every certificate below its bar, the same calls
    on the CPU, the C++ oracle at the same cost, and the port's float64
    condensing (raises SmokeFailure outside a bar)."""
    mpc, robot, inputs = engine_inputs(cuda_device, 64)
    (H, g, table, U), r = phase_oracle_certificate(cuda_device, "test", mpc, robot, inputs)
    assert U.shape == (64, 12 * mpc.horizon) and bool(torch.isfinite(U).all())
    assert r["kkt_max"] < 1e-7 and r["cpu_max_rel"] < 1e-8 and r["condense_H"] < 1e-9


def _loop_maker(dev, plant, solver, ticks, B=64):
    """A function that builds the same loop of ``plant`` each call, and its
    MPC parameters: the h=16 trot (SRB) or phase 11b's full-order trot."""
    if plant == "srb":
        mpc, robot, gait, cmd, _, state = closed_loop_setup(dev, B=B)
        return mpc, lambda: srb_env.RolloutLoop(robot, mpc, gait, cmd, ticks, init_state=state,
                                                solver=solver)
    mpc, robot, gait, cmd, state0 = fullorder_setup(dev, "11b", B)
    return mpc, lambda: fullorder.RolloutLoop(robot, mpc, gait, cmd, ticks, state0=state0,
                                              solver=solver)


def _under_profiler(loop, ticks):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ticks):
            loop.step()
    return prof


@pytest.mark.cuda
@pytest.mark.parametrize("plant,solver", [("srb", "riccati"), ("fullorder", "admm_fast")])
def test_cuda_traced_graph_equals_plain_graph(cuda_device, plant, solver):
    """100 ticks replayed from the traced graph (under a ``torch.profiler``)
    bit for bit the same ticks replayed from the plain graph; one plain
    capture a loop; every traced replay's stamps non-zero and in capture
    order, the solve ticks' rows empty; the layers' kernel nodes sum to the
    plain graph's; the eager solve ticks' spans carry device times; the
    spans are host events of the profiler's trace only."""
    ticks = 100
    mpc, make = _loop_maker(cuda_device, plant, solver, ticks)
    captures = graph_loop.CAPTURES
    plain = make()
    assert graph_loop.CAPTURES == captures + 1 and plain.traced_graph is not None
    for _ in range(ticks):
        plain.step()
    traced = make()
    prof = _under_profiler(traced, ticks)
    torch.cuda.synchronize()
    # The spans are host events of the trace, and lay nothing on the
    # device's timeline (a busy share would count it).
    on = lambda kind: {e.name for e in prof.events() if e.device_type == kind}
    assert {"tick.solve", "tick.replay", "solve.qp"} <= on(torch.autograd.DeviceType.CPU)
    assert not on(torch.autograd.DeviceType.CUDA) & {"tick.solve", "tick.replay", "solve.qp",
                                                     "tick.controller", "ctrl.pre"}
    _assert_bitwise(plain.result(True), traced.result(True))

    snap = profiling.snapshot()
    solve = [t for t in range(ticks) if ctrl.is_solve_tick(mpc, t)]
    replayed = [t for t in range(ticks) if t not in solve]
    for loop in (plain, traced):
        entry = snap["loops"][loop.loop_id]
        layers = sum(entry["nodes"][n] for n in ("tick.controller", "tick.plant", "tick.rows"))
        assert layers == profiling.graph_nodes(loop.graph)["kernel"]
        assert ("rbd.crba" in entry["nodes"]) == (plant == "fullorder")
    assert not snap["loops"][plain.loop_id]["stamps"].any()
    stamps = snap["loops"][traced.loop_id]["stamps"]
    assert (stamps[replayed] > 0).all() and not stamps[solve].any()
    assert (np.diff(stamps[replayed], axis=1) >= 0).all()
    assert (stamps[replayed, -1] > stamps[replayed, 0]).all()
    names = {n for n, *_ in snap["loops"][traced.loop_id]["layout"]}
    assert names >= {"tick.controller", "ctrl.pre", "ctrl.post", "tick.plant", "tick.rows"}
    cols = snap["spans"]["tick.solve"]
    mine = cols["loop"] == traced.loop_id
    assert mine.sum() == len(solve) and np.isfinite(cols["device_ms"][mine]).all()
    cols = snap["spans"]["tick.replay"]
    assert (cols["loop"] == traced.loop_id).sum() == len(replayed)


@pytest.mark.cuda
def test_cuda_solve_syncs_count_an_added_item(cuda_device, monkeypatch):
    """``solve.syncs`` per traced solve tick reads one more when the eager
    solve reads a device value on the host; the same read in
    ``srb.state_space``, which the tape's graphs replay, fails the tape's
    recording."""
    mpc, make = _loop_maker(cuda_device, "srb", "riccati", 40)

    def syncs_per_tick():
        before = profiling.snapshot()["counters"]
        _under_profiler(make(), 40)
        after = profiling.snapshot()["counters"]
        ticks = after["solve.traced_ticks"] - before.get("solve.traced_ticks", 0)
        assert ticks == 2
        return (after["solve.syncs"] - before.get("solve.syncs", 0)) / ticks

    base = syncs_per_tick()
    solve = riccati.solve_batch

    def solve_with_item(Ad, *args, **kwargs):
        Ad.sum().item()
        return solve(Ad, *args, **kwargs)

    monkeypatch.setattr(riccati, "solve_batch", solve_with_item)
    assert syncs_per_tick() == base + 1
    monkeypatch.setattr(riccati, "solve_batch", solve)
    inner = srb.state_space

    def with_item(robot, yaw, pos_base_feet):
        yaw.sum().item()
        return inner(robot, yaw, pos_base_feet)

    monkeypatch.setattr(srb, "state_space", with_item)
    with pytest.raises(RuntimeError):
        make()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("plant,solver", [("srb", "admm_fast"), ("srb", "riccati"),
                                          ("fullorder", "admm_fast")])
def test_cuda_solve_tick_does_not_synchronise(cuda_device, plant, solver):
    """The eager solve tick enqueues without a host synchronisation, so the
    host can run ahead of the card's replays: ``solve.syncs`` reads 0 over
    three traced solve ticks at B=64, and a second loop's three solve ticks
    run under ``torch.cuda.set_sync_debug_mode("error")``."""
    ticks = 60
    mpc, make = _loop_maker(cuda_device, plant, solver, ticks)
    before = profiling.snapshot()["counters"]
    _under_profiler(make(), ticks)
    after = profiling.snapshot()["counters"]
    assert after["solve.traced_ticks"] - before.get("solve.traced_ticks", 0) == 3
    assert after.get("solve.syncs", 0) - before.get("solve.syncs", 0) == 0
    loop = make()
    solved = 0
    for _ in range(ticks):
        if not ctrl.is_solve_tick(mpc, loop.next_tick):
            loop.step()
            continue
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.step()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        solved += 1
    (state, carry), _ = loop.result()
    assert solved == 3 and bool(torch.isfinite(carry.mpc.contact_forces).all())


@pytest.mark.cuda
def test_cuda_traced_capture_only_where_traced(cuda_device):
    """``capture.traced`` counts one traced graph for a loop its caller
    steps, none for a ``rollout()`` outside a profiler or a loop built after
    ``set_enabled(False)``, and one for a ``rollout()`` under a profiler,
    whose replays write its stamps; each loop captures one plain graph, and
    both rollouts give the same answer bit for bit."""
    ticks = 40
    mpc, robot, gait, cmd, _, state = closed_loop_setup(cuda_device, B=64)
    make = lambda: srb_env.RolloutLoop(robot, mpc, gait, cmd, ticks, init_state=state,
                                       solver="riccati")
    run = lambda: srb_env.rollout(robot, mpc, gait, cmd, ticks, init_state=state,
                                  solver="riccati", return_full_carry=True)

    def added():
        return graph_loop.CAPTURES - plain0, \
            profiling.snapshot()["counters"].get("capture.traced", 0) - traced0

    plain0 = graph_loop.CAPTURES
    traced0 = profiling.snapshot()["counters"].get("capture.traced", 0)
    assert make().traced_graph is not None and added() == (1, 1)
    untraced = run()
    assert added() == (2, 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        traced = run()
    assert added() == (3, 2)
    snap = profiling.snapshot()["loops"]
    assert snap[max(snap)]["stamps"].any()
    _assert_bitwise(untraced, traced)
    profiling.set_enabled(False)
    try:
        assert make().traced_graph is None and added() == (4, 2)
    finally:
        profiling.set_enabled(True)


@pytest.mark.cuda
@pytest.mark.parametrize("plant,solver", CLOSED_LOOPS)
def test_cuda_ctrl_tick_kernels_in_lockstep_with_the_plain_loop(cuda_device, monkeypatch, plant,
                                                                 solver):
    """200 ticks of the plain closed loop at B=256, run eagerly on the card,
    each tick's kernels (srb_observe, ctrl_pre, ctrl_post) reading the CUDA
    tensors the plain functions read: every output within the CPU tests'
    ulps, the exact fields equal (tests/test_torch_ctrl_tick.py)."""
    loop = closed_loop(plant, solver, cuda_device, 256, 200)
    worst = shadow_kernels(monkeypatch)
    for t in range(200):
        loop._tick(loop.buf, solve=ctrl.is_solve_tick(loop.mpc, t))
    assert_lockstep(worst, plant)


@pytest.mark.cuda
def test_cuda_ctrl_tick_closed_loop_holds_the_plain_loop(cuda_device, monkeypatch):
    """The SRB Riccati trot at B=256, 200 ticks through its graph, with the
    kernels and with the plain functions (their graph captured instead):
    every state, carry and metric leaf within the CPU test's LOOP_REL."""
    run = lambda: closed_loop("srb", "riccati", cuda_device, 256, 200)

    def result(loop):
        for _ in range(200):
            loop.step()
        return loop.result(return_full_carry=True)

    kernels = result(run())
    monkeypatch.setattr(ctrl_cuda, "engages", lambda *a: False)
    plain = result(run())
    assert not bool(plain[1]["diverged"].any())
    assert_loops_close(kernels, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("plant,solver,bound", [("srb", "riccati", 12), ("srb", "admm_fast", 12),
                                                ("fullorder", "admm_fast", 60)])
def test_cuda_ctrl_tick_graph_nodes(cuda_device, plant, solver, bound):
    """The captured graph's ``tick.controller`` holds at most ``bound``
    kernel nodes (491 SRB, 343 full-order with the plain functions)."""
    _, make = _loop_maker(cuda_device, plant, solver, 40)
    loop = make()
    nodes = profiling.snapshot()["loops"][loop.loop_id]["nodes"]
    assert nodes["tick.controller"] <= bound, nodes


@pytest.mark.cuda
def test_cuda_ctrl_tick_launches_on_eager_ticks_and_captures_not_replays(cuda_device):
    """``ctrl_cuda.LAUNCHES``: each kernel once a call of the tick while a
    loop warms up and captures (the graph's two warm-up calls, its plain and
    traced captures, the tape's two warm-up calls and its recording), never
    when a tick replays the graph or plays the tape."""
    mpc, make = _loop_maker(cuda_device, "srb", "riccati", 60)
    delta = lambda before: {k: ctrl_cuda.LAUNCHES[k] - before[k] for k in before}
    before = dict(ctrl_cuda.LAUNCHES)
    loop = make()
    built = 3 + (loop.traced_graph is not None) + 3
    assert loop.tape is not None and delta(before) == {k: built for k in before}
    before = dict(ctrl_cuda.LAUNCHES)
    for _ in range(2 * mpc.iterations_between_mpc):
        loop.step()
    torch.cuda.synchronize()
    assert delta(before) == {k: 0 for k in before}
    (state, _), metrics = loop.result()
    assert bool(torch.isfinite(state.pos).all()) and not bool(metrics["diverged"][:40].any())


@pytest.mark.cuda
@pytest.mark.parametrize("plant,solver", CLOSED_LOOPS)
def test_cuda_solve_tick_tape_replays_around_one_eager_solve(cuda_device, plant, solver):
    """A loop records its solve tick's tape when it is built: graph
    segments around one eager call (the warm-started solve); each solve
    tick plays it, and records every span the eager tick records, with a
    device time."""
    ticks = 60
    mpc, make = _loop_maker(cuda_device, plant, solver, ticks)
    loop = make()
    tape = loop.tape
    assert tape is not None
    calls = [item for item in tape.items if item[0] == "call"]
    assert len(calls) == 1 and calls[0][1] is ctrl._warm_solve
    graphs = [item[1] for item in tape.items if item[0] == "graph"]
    assert graphs and all(profiling.graph_nodes(g).get("kernel", 0) for g in graphs)
    marks = [item for item in tape.items if item[0] in ("enter", "exit")]
    assert len(marks) % 2 == 0 and {n for _, n in marks} >= {
        "tick.controller", "ctrl.pre", "solve.model", "solve.qp", "ctrl.post", "tick.plant",
        "tick.rows"}
    for _ in range(ticks):
        loop.step()
    torch.cuda.synchronize()
    snap = profiling.snapshot()
    for name in ("tick.solve", "tick.controller", "ctrl.pre", "solve.model", "solve.qp",
                 "ctrl.post", "tick.plant"):
        cols = snap["spans"][name]
        mine = cols["loop"] == loop.loop_id
        assert mine.sum() == 3 and np.isfinite(cols["device_ms"][mine]).all(), name
    (state, carry), metrics = loop.result()
    assert bool(torch.isfinite(carry.mpc.contact_forces).all())
    assert not bool(metrics["diverged"].any())
