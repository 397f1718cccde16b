"""Condensing, cones, build_qp and qp_residuals: the port against the JAX
package, plus the port's device defaults.

Inputs are trot-like h=16 scenarios made with numpy from a seed (B=3) and
fed to both frameworks.  H's entries span ~1e-5 (the R ridge) to ~1e2, and
the Gram product sums 208 f32 terms per entry, so H is compared with
atol = 1e-6 of max|H| and rtol 1e-5: the two frameworks' matrix products
reassociate those sums.  g sums the same way, at atol 1e-5 of max|g|.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu.control import refmpc as jrefmpc
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.ops import condense as jcondense
from pympc_quadruped_tpu.ops import srb as jsrb
from pympc_quadruped_tpu.ops.qp import cones as jcones
from pympc_quadruped_tpu.ops.qp import riccati as jriccati
from pympc_quadruped_tpu.utils import observability as jobs

from pympc_quadruped_tpu_torch import _build, convert, tree
from pympc_quadruped_tpu_torch.control import controller, refmpc
from pympc_quadruped_tpu_torch.control.refmpc import MpcCarry
from pympc_quadruped_tpu_torch.control.swing import SwingCarry
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.models.robots import a1
from pympc_quadruped_tpu_torch.ops import condense, srb
from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, cones, riccati
from pympc_quadruped_tpu_torch.utils import observability

torch.set_num_threads(1)

B, H = 3, 16


def qp_inputs(Bn, h, seed):
    """Trot-like (x_t, yaw, feet, X_ref, table) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    yaw = rng.uniform(-0.3, 0.3, Bn)
    feet = (np.array([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                      [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]])[None]
            + rng.normal(scale=0.03, size=(Bn, 4, 3)))
    x_t = np.concatenate([rng.normal(scale=0.05, size=(Bn, 2)), yaw[:, None],
                          rng.normal(scale=0.02, size=(Bn, 2)),
                          0.38 + rng.normal(scale=0.01, size=(Bn, 1)),
                          rng.normal(scale=0.3, size=(Bn, 3)),
                          1.2 + rng.normal(scale=0.2, size=(Bn, 1)),
                          rng.normal(scale=0.1, size=(Bn, 2)), np.full((Bn, 1), -9.81)], axis=1)
    X_ref = np.zeros((Bn, h, 13))
    X_ref[:, :, 2] = yaw[:, None]
    X_ref[:, :, 3] = x_t[:, 3:4] + 0.06 * np.arange(h)
    X_ref[:, :, 5] = 0.38
    X_ref[:, :, 9] = 1.2
    X_ref[:, :, 12] = -9.81
    table = np.zeros((Bn, h, 4))
    phase = rng.integers(0, 16, Bn)
    for b in range(Bn):
        seg = (phase[b] + np.arange(h)) % 16 < 8
        table[b, :, 0] = table[b, :, 3] = seg
        table[b, :, 1] = table[b, :, 2] = ~seg
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(x_t), f32(yaw), f32(feet), f32(X_ref), f32(table.reshape(Bn, 4 * h))


def jax_build_qp(arrays, h):
    robot, mpc = jaliengo(), JMpcParams(horizon=h)
    x_t, yaw, feet, X_ref, table = map(jnp.asarray, arrays)
    return jax.vmap(lambda x, y, p, Xr, t: jrefmpc.build_qp(robot, mpc, x, y, p, Xr, t))(
        x_t, yaw, feet, X_ref, table)


def port_build_qp(arrays, h):
    robot = tree.tile(aliengo(device="cpu"), arrays[0].shape[0])
    return refmpc.build_qp(robot, default_mpc_params(h, device="cpu"),
                           *map(torch.tensor, arrays))


def _close_to_scale(port, ref, rtol, frac):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=rtol, atol=frac * np.abs(ref).max())


def test_rollout_and_condense_match_jax():
    x_t, yaw, feet, X_ref, _ = qp_inputs(B, H, 0)
    robot_j, mpc_j = jaliengo(), JMpcParams(horizon=H)
    Ad_j, Bd_j = jax.vmap(lambda y, p: jsrb.discretize(
        *jsrb.state_space(robot_j, y, p), mpc_j.dt_predict))(yaw, feet)
    Sx_j, Su_j = jax.vmap(lambda a, b: jcondense.rollout_matrices(a, b, H))(Ad_j, Bd_j)
    Hj, gj = jax.vmap(lambda a, b, x, r: jcondense.condense(a, b, x, r.reshape(-1), mpc_j))(
        Ad_j, Bd_j, x_t, X_ref)
    Ad, Bd = torch.tensor(np.asarray(Ad_j)), torch.tensor(np.asarray(Bd_j))
    mpc = default_mpc_params(H, device="cpu")
    Sx, Su = condense.rollout_matrices(Ad, Bd, H)
    _close_to_scale(Sx, Sx_j, 1e-5, 1e-6)
    _close_to_scale(Su, Su_j, 1e-5, 1e-6)
    Hp, gp = condense.condense(Ad, Bd, torch.tensor(x_t), torch.tensor(X_ref), mpc)
    _close_to_scale(Hp, Hj, 1e-5, 1e-6)
    _close_to_scale(gp, gj, 1e-5, 1e-5)
    assert torch.equal(Hp, Hp.transpose(-1, -2))


@pytest.mark.parametrize("h", [10, H])
def test_qp_cost_toeplitz_matches_jax_and_the_gram_form(h):
    """The block-Toeplitz condensing against JAX's at the tolerances above,
    and against the port's Gram form (``condense``) at
    tests/test_condense.py:103's bars: max|dH| / max|H| and
    max|dg| / (max|g| + 1) below 1e-6; H exactly symmetric."""
    x_t, yaw, feet, X_ref, _ = qp_inputs(B, h, 5)
    robot_j, mpc_j = jaliengo(), JMpcParams(horizon=h)
    Ad_j, Bd_j = jax.vmap(lambda y, p: jsrb.discretize(
        *jsrb.state_space(robot_j, y, p), mpc_j.dt_predict))(yaw, feet)
    Hj, gj = jax.vmap(lambda a, b, x, r: jcondense.qp_cost_toeplitz(a, b, x, r.reshape(-1),
                                                                     mpc_j))(
        Ad_j, Bd_j, x_t, X_ref)
    Ad, Bd = torch.tensor(np.asarray(Ad_j)), torch.tensor(np.asarray(Bd_j))
    mpc = default_mpc_params(h, device="cpu")
    x_t, X_ref = torch.tensor(x_t), torch.tensor(X_ref)
    Ht, gt = condense.qp_cost_toeplitz(Ad, Bd, x_t, X_ref, mpc)
    _close_to_scale(Ht, Hj, 1e-5, 1e-6)
    _close_to_scale(gt, gj, 1e-5, 1e-5)
    assert torch.equal(Ht, Ht.transpose(-1, -2))
    Hg, gg = (t.double() for t in condense.condense(Ad, Bd, x_t, X_ref, mpc))
    assert float((Ht.double() - Hg).abs().max() / Hg.abs().max()) < 1e-6
    assert float((gt.double() - gg).abs().max() / (gg.abs().max() + 1.0)) < 1e-6


def test_cone_block_matches_jax():
    np.testing.assert_array_equal(riccati.cone_block(device="cpu").numpy(),
                                  np.asarray(jriccati.cone_block()))


def test_build_qp_matches_jax():
    arrays = qp_inputs(B, H, 1)
    Hj, gj, mvj = jax_build_qp(arrays, H)
    Hp, gp, mv = port_build_qp(arrays, H)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mvj))
    _close_to_scale(Hp, Hj, 1e-5, 1e-6)
    _close_to_scale(gp, gj, 1e-5, 1e-5)
    # Pinned swing variables: identity rows, zero gradient, exactly.
    swing = mv[0] == 0
    assert torch.equal(Hp[0][swing][:, swing], torch.eye(int(swing.sum())))
    assert torch.equal(gp[0][swing], torch.zeros(int(swing.sum())))


def test_mask_cost_and_block_constraints_match_jax():
    rng = np.random.default_rng(2)
    Hm = rng.normal(size=(B, 24, 24)).astype(np.float32)
    g = rng.normal(size=(B, 24)).astype(np.float32)
    table = (rng.uniform(size=(B, 8)) > 0.5).astype(np.float32)
    mv = np.repeat(table, 3, axis=-1)
    mpc_j = JMpcParams(horizon=2)
    Hj, gj = jax.vmap(jcones.mask_cost)(Hm, g, mv)
    Hp, gp = cones.mask_cost(*map(torch.tensor, (Hm, g, mv)))
    np.testing.assert_array_equal(Hp.numpy(), np.asarray(Hj))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(gj))
    fz = np.float32([500.0, 300.0, 100.0])
    Gj, hj, sj = jax.vmap(lambda t, f: jcones.block_constraints(t, f, mpc_j))(table, fz)
    Gp, hp, sp = cones.block_constraints(torch.tensor(table), torch.tensor(fz),
                                         default_mpc_params(2, device="cpu"))
    for p, j in ((Gp, Gj), (hp, hj), (sp, sj)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_qp_residuals_match_jax():
    arrays = qp_inputs(B, H, 3)
    Hj, gj, _ = jax_build_qp(arrays, H)
    U = np.random.default_rng(4).normal(scale=30.0, size=(B, 12 * H)).astype(np.float32)
    U[:, 2::3] = np.abs(U[:, 2::3]) + 10.0
    ref = jobs.qp_residuals(Hj, gj, jnp.asarray(arrays[4]), jnp.float32(500.0), jnp.asarray(U),
                            JMpcParams(horizon=H))
    port = observability.qp_residuals(torch.tensor(np.asarray(Hj)), torch.tensor(np.asarray(gj)),
                                      torch.tensor(arrays[4]), torch.tensor(500.0),
                                      torch.tensor(U), default_mpc_params(H, device="cpu"))
    for key in ref:
        np.testing.assert_allclose(port[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-4)


# The condensing kernel's arithmetic (csrc/condense.cuh), through its host
# build (csrc/condense_host.cpp) and admm_cuda.condense's ``lib`` argument.

#: Per scenario max |d| over max |ref|, as the benchmark's ``qp_data`` reads
#: an operand: a third of its 3e-5 limit.  The host build reads at most
#: 7.9e-7 against the plain condensing and 1.1e-6 against JAX's build_qp
#: (h = 10 and 16, B up to 16, four seeds): sums in another order, H's
#: running Toeplitz sums and the free trajectory by steps x <- Ad x.
KERNEL_REL_TOL = 1e-5


@pytest.fixture(scope="module")
def condense_host(tmp_path_factory):
    """csrc/condense.cuh compiled for the CPU (csrc/condense_host.cpp)."""
    return _build.build_host("condense_host.cpp", tmp_path_factory.mktemp("condense_host"))


def with_flight(arrays):
    """``qp_inputs`` with scenario 0's four legs in flight at steps 2 and 3."""
    table = arrays[4].copy()
    table[0, 8:16] = 0.0
    return arrays[:4] + (table,)


def kernel_operands(arrays, h):
    """(mpc, Ad, Bd, x_t, X_ref (B,h,13), mv) as ``build_qp`` forms them."""
    x_t, yaw, feet, X_ref, table = map(torch.tensor, arrays)
    robot = tree.tile(aliengo(device="cpu"), x_t.shape[0])
    mpc = default_mpc_params(h, device="cpu")
    Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
    return mpc, Ad, Bd, x_t, X_ref, cones.variable_mask(table, mpc)


def per_scenario_rel(got, ref) -> float:
    got, ref = (np.array(a, dtype=np.float64).reshape(a.shape[0], -1) for a in (got, ref))
    return float((np.abs(got - ref).max(-1) / np.abs(ref).max(-1)).max())


def assert_pinned(H, g, mv):
    """H exactly symmetric; masked rows and columns exactly identity, g
    exactly 0 there."""
    assert torch.equal(H, H.transpose(-1, -2))
    eye = torch.eye(H.shape[-1])
    for b in range(H.shape[0]):
        swing = mv[b] == 0
        assert torch.equal(H[b][swing], eye[swing])
        assert torch.equal(H[b][:, swing], eye[:, swing])
        assert torch.equal(g[b][swing], torch.zeros(int(swing.sum())))


@pytest.mark.parametrize("layout", ["flat", "steps"])
@pytest.mark.parametrize("Bn", [1, 4])
@pytest.mark.parametrize("h", [10, H])
def test_condense_kernel_code_matches_plain(h, Bn, layout, condense_host):
    """The kernel's per-scenario code against ``cones.mask_cost(
    *condense.condense(...), mv)``, X_ref as (B,13h) or (B,h,13), swing legs
    masked and one scenario in flight: H and g within KERNEL_REL_TOL per
    scenario, H exactly symmetric, the masked variables pinned exactly."""
    mpc, Ad, Bd, x_t, X_ref, mv = kernel_operands(with_flight(qp_inputs(Bn, h, 7 + Bn)), h)
    X_in = X_ref.reshape(Bn, -1) if layout == "flat" else X_ref
    Hk, gk = admm_cuda.condense(Ad, Bd, x_t, X_in, mv, mpc, lib=condense_host)
    Hp, gp = cones.mask_cost(*condense.condense(Ad, Bd, x_t, X_ref, mpc), mv)
    assert per_scenario_rel(Hk, Hp) < KERNEL_REL_TOL
    assert per_scenario_rel(gk, gp) < KERNEL_REL_TOL
    assert_pinned(Hk, gk, mv)
    assert int((mv == 0).sum()) > 0 and admm_cuda.LAUNCHES["condense"] == 0


@pytest.mark.parametrize("h", [10, H])
def test_condense_kernel_code_matches_jax(h, condense_host):
    """The kernel's per-scenario code against the JAX package's
    ``build_qp`` on the same scenarios (one in flight), at KERNEL_REL_TOL."""
    arrays = with_flight(qp_inputs(B, h, 9))
    Hj, gj, mvj = jax_build_qp(arrays, h)
    mpc, Ad, Bd, x_t, X_ref, mv = kernel_operands(arrays, h)
    Hk, gk = admm_cuda.condense(Ad, Bd, x_t, X_ref, mv, mpc, lib=condense_host)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mvj))
    assert per_scenario_rel(Hk, Hj) < KERNEL_REL_TOL
    assert per_scenario_rel(gk, gj) < KERNEL_REL_TOL
    assert_pinned(Hk, gk, mv)


def test_condense_kernel_refuses_a_horizon_beyond_its_plan(condense_host):
    """Past ``condense_max_horizon`` the wrapper raises before a launch and
    the launcher itself refuses."""
    h = condense_host.condense_max_horizon() + 1
    mpc, Ad, Bd, x_t, X_ref, mv = kernel_operands(qp_inputs(1, h, 3), h)
    with pytest.raises(ValueError, match="plans at most"):
        admm_cuda.condense(Ad, Bd, x_t, X_ref, mv, mpc, lib=condense_host)
    n = 12 * h
    H_out, g_out = torch.zeros(1, n, n), torch.zeros(1, n)
    rc = condense_host.condense_launch(
        *(t.data_ptr() for t in (Ad, Bd, x_t, X_ref, mv, mpc.q_diag, mpc.r_diag, H_out, g_out)),
        1, h, None)
    assert rc != 0 and not H_out.any()


def test_build_qp_condenses_plainly_off_the_card():
    """On the CPU ``build_qp`` keeps the plain condensing: no kernel, and
    its (H, g) bit for bit ``mask_cost(*condense(...), mv)``."""
    arrays = with_flight(qp_inputs(B, H, 4))
    mpc, Ad, Bd, x_t, X_ref, mv = kernel_operands(arrays, H)
    assert not admm_cuda.condenses_on_card(x_t, mpc, Ad, Bd, X_ref, mv)
    before = dict(admm_cuda.LAUNCHES)
    Hb, gb, mvb = port_build_qp(arrays, H)
    Hp, gp = cones.mask_cost(*condense.condense(Ad, Bd, x_t, X_ref, mpc), mv)
    assert torch.equal(Hb, Hp) and torch.equal(gb, gp) and torch.equal(mvb, mv)
    assert admm_cuda.LAUNCHES == before


CONSTRUCTORS = {  # name -> (constructor, positional arguments)
    "aliengo": (aliengo, ()), "a1": (a1, ()), "Gaits.trotting16": (Gaits.trotting16, ()),
    "Gaits.by_name": (Gaits.by_name, ("pacing10",)),
    "Command.trot_forward": (Command.trot_forward, ()),
    "default_mpc_params": (default_mpc_params, ()), "cone_block": (riccati.cone_block, ()), "MpcCarry.init": (MpcCarry.init, ()),
    "SwingCarry.init": (SwingCarry.init, ()), "init_carry": (controller.init_carry, ()),
    "convert.robot_params": (convert.robot_params,
                             (convert.as_arrays(aliengo(device="cpu")),)),
    "convert.controller_carry": (convert.controller_carry,
                                 (convert.as_arrays(controller.init_carry(device="cpu")),)),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """Every public constructor builds on the card unless told otherwise; on
    a machine with no card the default raises, as PyTorch does, and nothing
    falls back to the CPU."""
    fn, args = CONSTRUCTORS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        devices = []
        tree.tree_map(lambda t: devices.append(t.device.type), fn(*args))
        assert devices and set(devices) == {"cuda"}
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args)
