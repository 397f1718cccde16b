"""The parity solvers and what surrounds them: the port against the JAX
package and the float64 oracle.

- ``cones``' block products against JAX, elementwise (atol and rtol 1e-6), the
  dense normal matrix included, for 5- and 6-row blocks.
- ``admm``: ``pyramid_rows`` and ``admm_constraints`` equal JAX's exactly;
  ``solve_batch`` on tests/test_qp.py's instances has a cost gap to the
  f64 oracle below 1e-4 of the cost scale (tests/test_qp.py:150-166), and
  its f64 cost differs from the JAX solve's by less than COST_VS_JAX.
- ``ipm``: the throughput configuration's gap below 1e-5
  (tests/test_qp.py:125-147); ``PARITY_CONFIG`` within 1e-3 of the oracle
  per component (tests/test_qp.py:104-122), on the f32-rounded data
  without low words and on data with random f32 low words that the oracle
  sees in float64; batched equals one by one (atol 1e-3); the NaN
  knife-edge fixture keeps tests/test_qp.py:242-271's safety bars.
- ``condense_ff`` from the same f32 Ad/Bd: hi + lo in float64 within 1e-10
  of JAX's float-float hi + lo, relative to H's scale.  ``build_qp_ff``,
  whose Ad/Bd each framework discretizes in f32, at build_qp's bars
  (tests/test_torch_condense.py) and with masks exact.
- ``engine``'s ``admm_ref`` and ``ipm`` routes and ``refmpc.solve_mpc``
  against JAX's on the QP's invariants: the f32 condensed QP is
  ill-conditioned (reduced-Hessian lambda_min ~ 2R = 4e-5), so two f32
  solvers agree on cost, cone rows and total vertical support, not per
  force component.  The ``ValueError`` of ``warm``/``return_duals`` off
  the fast and Riccati paths.
- ``observability``'s f64 KKT certificate and gate against JAX's (rtol
  1e-12; stat_rel, a normalized residual, also atol 1e-12), the metrics
  logger; ``profiling``'s keys; ``convert``'s configs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu import engine as jengine
from pympc_quadruped_tpu.control import refmpc as jrefmpc
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.ops import condense as jcondense
from pympc_quadruped_tpu.ops import srb as jsrb
from pympc_quadruped_tpu.ops.qp import admm as jadmm
from pympc_quadruped_tpu.ops.qp import cones as jcones
from pympc_quadruped_tpu.ops.qp import ipm as jipm
from pympc_quadruped_tpu.utils import observability as jobs
from pympc_quadruped_tpu.utils import profiling as jprof

from pympc_quadruped_tpu_torch import convert, engine, tree
from pympc_quadruped_tpu_torch.control import refmpc
from pympc_quadruped_tpu_torch.models import aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.ops import condense
from pympc_quadruped_tpu_torch.ops.qp import admm, cones, ipm
from pympc_quadruped_tpu_torch.utils import observability, profiling
from test_qp import H_STEPS, _cost_gap, _masked, _mpc_instance, _oracle_solution
from test_torch_condense import jax_build_qp, qp_inputs

torch.set_num_threads(1)

FZ_MAX, MU = 500.0, 0.7
# Two-sided f64 cost difference |c - c_jax| / (|c_jax| + 1) between the
# port's and JAX's solve of the same QP (measured up to 6.6e-8 over these
# cases and other seeds, both routes).
COST_VS_JAX = 5e-7
# Total vertical support of one step [N] (of ~90 N), port against JAX: each
# framework condenses its own f32 H, and the 1e-7 relative difference
# moves the f32 optimum along the QP's weak directions (measured up to
# 0.25 N over these cases and other seeds).
SUPPORT_VS_JAX = 1.0


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _f64(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def _cost(H, g, U):
    """Per-scenario f64 cost 1/2 U^T H U + g^T U (batched)."""
    H, g, U = _f64(H), _f64(g), _f64(U)
    return 0.5 * np.einsum("bi,bij,bj->b", U, H, U) + np.sum(g * U, -1)


def _cone_violation(U, table, h):
    """Worst friction-pyramid violation [N] of swing-masked U (B,12h)."""
    f = _f64(U).reshape(len(U), h, 4, 3)
    st = np.asarray(table).reshape(len(U), h, 4) > 0
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    viol = np.maximum.reduce([np.abs(fx) - MU * fz, np.abs(fy) - MU * fz, -fz, fz - FZ_MAX])
    return np.max(np.where(st, viol, 0.0), axis=(-1, -2))


def _support(U, h):
    """Total vertical support per step [N]: (B, h)."""
    return _f64(U).reshape(len(U), h, 4, 3)[..., 2].sum(-1)


# ---------------------------------------------------------------------------
# cones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [5, 6])
def test_block_products_match_jax(rows):
    rng = np.random.default_rng(rows)
    Bn, h = 3, 4
    G = rng.uniform(-1.0, 1.0, size=(Bn, h, 4, rows, 3)).astype(np.float32)
    d = rng.uniform(0.1, 1.0, size=(Bn, h, 4, rows)).astype(np.float32)
    x = rng.normal(size=(Bn, 12 * h)).astype(np.float32)
    pairs = [
        (cones.block_matvec(_t(G), _t(x)), jax.vmap(jcones.block_matvec)(G, x)),
        (cones.block_rmatvec(_t(G), _t(d)), jax.vmap(jcones.block_rmatvec)(G, d)),
        (cones.block_normal_matrix(_t(G), _t(d)), jax.vmap(jcones.block_normal_matrix)(G, d)),
    ]
    for port, ref in pairs:
        assert tuple(port.shape) == np.shape(ref)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # Off the 3x3 diagonal blocks the dense normal matrix is exactly zero.
    N = pairs[2][0].numpy().reshape(Bn, 4 * h, 3, 4 * h, 3)
    off = ~np.eye(4 * h, dtype=bool)
    assert np.all(N.transpose(0, 1, 3, 2, 4)[:, off] == 0.0)


# ---------------------------------------------------------------------------
# admm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_scenario_fz", [False, True])
def test_admm_constraints_match_jax(per_scenario_fz):
    rng = np.random.default_rng(4)
    Bn, h = 3, 10
    table = (rng.uniform(size=(Bn, 4 * h)) > 0.4).astype(np.float32)
    fz = np.float32([500.0, 420.0, 380.0]) if per_scenario_fz else np.float32(FZ_MAX)
    mpc_j = JMpcParams(horizon=h)
    Aj, lj, uj = jax.vmap(lambda t, f: jadmm.admm_constraints(t, f, mpc_j))(
        table, np.broadcast_to(fz, (Bn,)))
    A, l, u = admm.admm_constraints(_t(table), torch.tensor(fz),
                                    default_mpc_params(h, device="cpu"))
    for port, ref in ((A, Aj), (l, lj), (u, uj)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(admm.pyramid_rows(torch.tensor(MU)).numpy(),
                                  np.asarray(jadmm.pyramid_rows(jnp.float32(MU))))


def _oracle_case(tick):
    """tests/test_qp.py's instance: the masked f32 QP, its f64 data and the
    certified oracle optimum."""
    mpc, robot, H64, g64, table = _mpc_instance(tick)
    U_star = _oracle_solution(H64, g64, table)
    Hm, gm, mv = _masked(H64, g64, table)
    return dict(H64=H64, g64=g64, table=table, U_star=U_star, Hm=Hm, gm=gm, mv=mv,
                mpc=default_mpc_params(H_STEPS, device="cpu"), mpc_j=mpc)


def _gap_of(c, U):
    """Cost gap of U (n,) to the oracle over the cost scale (test_qp.py)."""
    mv = c["mv"]
    Hmm = c["H64"] * np.outer(mv, mv) + np.diag(1 - mv)
    scale = abs(0.5 * c["U_star"] @ c["H64"] @ c["U_star"] + c["g64"] @ c["U_star"]) + 1.0
    return _cost_gap(Hmm, c["g64"] * mv, U * mv, c["U_star"] * mv) / scale


@pytest.mark.parametrize("tick", [0, 340])
def test_admm_quality_against_oracle_and_jax(tick):
    c = _oracle_case(tick)
    A, l, u = admm.admm_constraints(_t(c["table"])[None], FZ_MAX, c["mpc"])
    U = _f64(admm.solve_batch(_t(c["Hm"])[None], _t(c["gm"])[None], A, l, u))[0] * c["mv"]
    assert np.all(np.isfinite(U))
    assert _gap_of(c, U) < 1e-4
    Aj, lj, uj = jadmm.admm_constraints(jnp.asarray(c["table"], jnp.float32), FZ_MAX, c["mpc_j"])
    U_j = _f64(jadmm.solve_batch(jnp.asarray(c["Hm"], jnp.float32)[None],
                                 jnp.asarray(c["gm"], jnp.float32)[None],
                                 Aj[None], lj[None], uj[None]))[0] * c["mv"]
    cj = _cost(c["Hm"][None], c["gm"][None], U_j[None])
    assert np.abs(_cost(c["Hm"][None], c["gm"][None], U[None]) - cj) / (np.abs(cj) + 1.0) \
        < COST_VS_JAX


# ---------------------------------------------------------------------------
# ipm
# ---------------------------------------------------------------------------

def _ipm(c, cfg=ipm.IpmConfig(), H_lo=None, g_lo=None, Hm=None, gm=None):
    G, h_vec, _ = cones.block_constraints(_t(c["table"])[None], FZ_MAX, c["mpc"])
    Hm = c["Hm"] if Hm is None else Hm
    gm = c["gm"] if gm is None else gm
    lo = lambda a: None if a is None else _t(a)[None]
    U = ipm.solve_batch(_t(Hm)[None], _t(gm)[None], G, h_vec, cfg, lo(H_lo), lo(g_lo))
    return _f64(U)[0] * c["mv"]


@pytest.mark.parametrize("tick", [0, 340])
def test_ipm_throughput_quality(tick):
    c = _oracle_case(tick)
    U = _ipm(c)
    assert np.all(np.isfinite(U))
    assert _gap_of(c, U) < 1e-5


@pytest.mark.parametrize("low_words", [False, True])
@pytest.mark.parametrize("tick", [0, 100, 340, 660])
def test_parity_ipm_matches_oracle_1e3(tick, low_words):
    """BASELINE bar: every component within 1e-3 of the f64 oracle.  With
    ``low_words`` the problem is H + H_lo, g + g_lo with random f32 low
    words of up to half an f32 ulp of the data (what f32 rounding leaves
    of f64 data), solved by the oracle in float64 and handed to the IPM as
    its two words."""
    c = _oracle_case(tick)
    H_lo = g_lo = None
    if low_words:
        rng = np.random.default_rng(tick)
        ulp = lambda a: np.spacing(np.abs(a).astype(np.float32)).astype(np.float64)
        H_lo = 0.5 * ulp(c["H64"]) * rng.uniform(-1, 1, c["H64"].shape)
        H_lo = np.float32(0.5 * (H_lo + H_lo.T)).astype(np.float64)
        g_lo = np.float32(0.5 * ulp(c["g64"]) * rng.uniform(-1, 1, c["g64"].shape))
        g_lo = g_lo.astype(np.float64)
        c["U_star"] = _oracle_solution(c["H64"] + H_lo, c["g64"] + g_lo, c["table"])
        mv = c["mv"]
        H_lo, g_lo = H_lo * np.outer(mv, mv), g_lo * mv
    U = _ipm(c, ipm.PARITY_CONFIG, H_lo, g_lo)
    rel = np.max(np.abs(U - c["U_star"]) / (1.0 + np.abs(c["U_star"])))
    assert rel < 1e-3, f"parity IPM vs oracle rel err {rel:.2e}"


def test_ipm_batched_equals_one_by_one():
    cs = [_oracle_case(t) for t in (0, 100, 340)]
    mpc = cs[0]["mpc"]
    G, h_vec, _ = cones.block_constraints(_t(np.stack([c["table"] for c in cs])), FZ_MAX, mpc)
    Hs, gs = _t(np.stack([c["Hm"] for c in cs])), _t(np.stack([c["gm"] for c in cs]))
    U_batch = ipm.solve_batch(Hs, gs, G, h_vec, ipm.PARITY_CONFIG).numpy()
    for i in range(3):
        U_i = ipm.solve_batch(Hs[i:i + 1], gs[i:i + 1], G[i:i + 1], h_vec[i:i + 1],
                              ipm.PARITY_CONFIG).numpy()[0]
        np.testing.assert_allclose(U_batch[i], U_i, atol=1e-3)


def test_ipm_nan_knife_edge_regression():
    """tests/test_qp.py:242-271's fixture: a slightly indefinite H on which
    an f32 Cholesky step NaN-poisoned the iterate.  The finite-step guard
    (alpha = 0 where cho_factor's factor is NaN) must keep the solution
    finite, swing forces zero, stance forces in the pyramid and every
    step's support above 20 N."""
    d = np.load(os.path.join(os.path.dirname(__file__), "data", "qp_nan_knife_edge.npz"))
    U = ipm.solve_batch(*(torch.tensor(d[k])[None] for k in ("H", "g", "G", "h")))[0]
    U = _f64(U)
    assert np.all(np.isfinite(U)), "IPM returns non-finite forces"
    U = (U * d["mv"]).reshape(H_STEPS, 4, 3)
    stance = d["table"].reshape(H_STEPS, 4)
    np.testing.assert_allclose(U[stance == 0.0], 0.0, atol=1e-6)
    tol = 1e-2
    fz = U[..., 2]
    assert np.all(fz >= -tol) and np.all(fz <= FZ_MAX + tol)
    assert np.all(np.abs(U[..., 0]) <= MU * fz + tol)
    assert np.all(np.abs(U[..., 1]) <= MU * fz + tol)
    assert np.all((fz * stance).sum(axis=1) > 20.0)


def test_cho_factor_gives_nan_per_scenario():
    """A scenario that is not positive definite gets an all-NaN factor, as
    ``jnp.linalg.cholesky`` gives it; the others are untouched."""
    M = torch.eye(4).repeat(3, 1, 1)
    M[1, 2, 2] = -1.0
    L = admm.cho_factor(M)
    assert torch.isnan(L[1]).all()
    assert torch.equal(L[0], torch.eye(4)) and torch.equal(L[2], torch.eye(4))


# ---------------------------------------------------------------------------
# condense_ff, build_qp_ff, solve_mpc
# ---------------------------------------------------------------------------

def test_condense_ff_matches_jax_float_float():
    h = 10
    x_t, yaw, feet, X_ref, _ = qp_inputs(3, h, 5)
    robot_j, mpc_j = jaliengo(), JMpcParams(horizon=h)
    Ad, Bd = jax.vmap(lambda y, p: jsrb.discretize(
        *jsrb.state_space(robot_j, y, p), mpc_j.dt_predict))(yaw, feet)
    ref = jax.vmap(lambda a, b, x, r: jcondense.condense_ff(a, b, x, r.reshape(-1), mpc_j))(
        Ad, Bd, x_t, X_ref)
    port = condense.condense_ff(_t(Ad), _t(Bd), _t(x_t), _t(X_ref),
                                default_mpc_params(h, device="cpu"))
    H_j, g_j = _f64(ref[0]) + _f64(ref[1]), _f64(ref[2]) + _f64(ref[3])
    H_p, g_p = _f64(port[0]) + _f64(port[1]), _f64(port[2]) + _f64(port[3])
    assert all(t.dtype == torch.float32 for t in port)
    np.testing.assert_allclose(H_p, H_j, rtol=0, atol=1e-10 * np.abs(H_j).max())
    np.testing.assert_allclose(g_p, g_j, rtol=0, atol=1e-10 * np.abs(g_j).max())
    # hi is the f32 rounding of the f64 value: |lo| within half an ulp of hi.
    assert np.all(np.abs(_f64(port[1])) <= 0.5 * np.spacing(np.abs(port[0].numpy())))


def test_build_qp_ff_matches_jax():
    h = 10
    arrays = qp_inputs(3, h, 6)
    robot_j, mpc_j = jaliengo(), JMpcParams(horizon=h)
    ref = jax.vmap(lambda x, y, p, Xr, t: jrefmpc.build_qp_ff(robot_j, mpc_j, x, y, p, Xr, t))(
        *map(jnp.asarray, arrays))
    robot = tree.tile(aliengo(device="cpu"), 3)
    port = refmpc.build_qp_ff(robot, default_mpc_params(h, device="cpu"),
                              *map(torch.tensor, arrays))
    np.testing.assert_array_equal(port[4].numpy(), np.asarray(ref[4]))
    H_j, g_j = _f64(ref[0]) + _f64(ref[1]), _f64(ref[2]) + _f64(ref[3])
    H_p, g_p = _f64(port[0]) + _f64(port[1]), _f64(port[2]) + _f64(port[3])
    np.testing.assert_allclose(H_p, H_j, rtol=1e-5, atol=1e-6 * np.abs(H_j).max())
    np.testing.assert_allclose(g_p, g_j, rtol=1e-5, atol=1e-5 * np.abs(g_j).max())
    # Swing rows and columns: identity hi word, zero lo word and gradient.
    swing = port[4][0] == 0
    assert torch.equal(port[0][0][swing][:, swing], torch.eye(int(swing.sum())))
    assert not port[1][0][swing].any() and not port[3][0][swing].any()


@pytest.mark.parametrize("solver", ["ipm", "admm"])
def test_solve_mpc_matches_jax_and_engine(solver):
    """Single-scenario solve: exactly the engine route's first step, swing
    legs exactly zero, and JAX's total vertical support."""
    h = 10
    arrays = qp_inputs(1, h, 7)
    robot_j, mpc_j = jaliengo(), JMpcParams(horizon=h)
    f_j = _f64(jrefmpc.solve_mpc(robot_j, mpc_j, *(jnp.asarray(a[0]) for a in arrays),
                                 solver=solver))
    mpc = default_mpc_params(h, device="cpu")
    f = refmpc.solve_mpc(aliengo(device="cpu"), mpc, *(torch.tensor(a[0]) for a in arrays),
                         solver=solver)
    route = {"ipm": "ipm", "admm": "admm_ref"}[solver]
    f_e = engine.solve_scenarios(aliengo(device="cpu"), mpc, *map(torch.tensor, arrays),
                                 solver=route)[0]
    assert torch.equal(f, f_e)
    assert tuple(f.shape) == (12,)
    stance = arrays[4][0, :4]
    assert np.all(f.numpy().reshape(4, 3)[stance == 0] == 0.0)
    assert abs(_f64(f).reshape(4, 3)[:, 2].sum() - f_j.reshape(4, 3)[:, 2].sum()) \
        < SUPPORT_VS_JAX


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["admm_ref", "ipm"])
def test_engine_route_matches_jax_on_invariants(route):
    """B=3 trot-like h=10 scenarios: the port's and JAX's route on the same
    inputs agree on the f64 cost of the full horizon (COST_VS_JAX), on
    each step's total vertical support (SUPPORT_VS_JAX) and both keep the
    cone rows within 1e-3 fz_max; swing forces are exactly zero."""
    h, Bn = 10, 3
    arrays = qp_inputs(Bn, h, 8)
    mpc_j = JMpcParams(horizon=h)
    U_j = _f64(jengine.solve_scenarios(jaliengo(), mpc_j, *map(jnp.asarray, arrays),
                                       solver=route, return_full_horizon=True))
    U = engine.solve_scenarios(aliengo(device="cpu"), default_mpc_params(h, device="cpu"),
                               *map(torch.tensor, arrays), solver=route,
                               return_full_horizon=True)
    Hj, gj, mvj = jax_build_qp(arrays, h)
    c, cj = _cost(Hj, gj, U), _cost(Hj, gj, U_j)
    assert np.all(np.abs(c - cj) / (np.abs(cj) + 1.0) < COST_VS_JAX), (c, cj)
    assert np.all(np.abs(_support(U, h) - _support(U_j, h)) < SUPPORT_VS_JAX)
    assert np.all(_cone_violation(U, arrays[4], h) < 1e-3 * FZ_MAX)
    assert torch.all(U[torch.tensor(np.asarray(mvj)) == 0] == 0.0)


@pytest.mark.parametrize("route", ["admm_ref", "ipm"])
@pytest.mark.parametrize("arg", ["warm", "return_duals"])
def test_engine_rejects_warm_and_duals_off_the_fast_paths(route, arg):
    h = 10
    arrays = qp_inputs(1, h, 9)
    kwargs = ({"warm": (torch.zeros(1, 12 * h), torch.zeros(1, 20 * h))} if arg == "warm"
              else {"return_duals": True, "return_full_horizon": True})
    with pytest.raises(ValueError, match="warm/return_duals"):
        engine.solve_scenarios(aliengo(device="cpu"), default_mpc_params(h, device="cpu"),
                               *map(torch.tensor, arrays), solver=route, **kwargs)


# ---------------------------------------------------------------------------
# observability, profiling, convert
# ---------------------------------------------------------------------------

def test_kkt_certificate_matches_jax():
    """The port's f64 certificate on the card's path equals JAX's host one
    on the same (H, g, table, U, lam); the gate agrees."""
    h, Bn = 10, 4
    arrays = qp_inputs(Bn, h, 10)
    mpc = default_mpc_params(h, device="cpu")
    fz = torch.tensor([500.0, 450.0, 500.0, 400.0])
    robot = tree.tile(aliengo(device="cpu"), Bn)
    robot.fz_max = fz
    U, lam = engine.solve_scenarios(robot, mpc, *map(torch.tensor, arrays),
                                    return_full_horizon=True, return_duals=True)
    H, g, _ = refmpc.build_qp(robot, mpc, *map(torch.tensor, arrays))
    res = observability.kkt_residuals_f64(H, g, torch.tensor(arrays[4]), fz, U, lam, mpc)
    ref = jobs.kkt_residuals_f64(H.numpy(), g.numpy(), arrays[4], fz.numpy(), U.numpy(),
                                 lam.numpy(), JMpcParams(horizon=h))
    assert set(res) == set(ref)
    for key in ref:
        assert res[key].dtype in (torch.float64, torch.bool)
        # stat_rel is a residual near cancellation over the gradient scale;
        # the two f64 summation orders (numpy's einsum, torch's matmul)
        # differ there by ~3e-14 of that scale, hence 1e-12 absolute.
        atol = 1e-12 if key == "stat_rel" else 0.0
        np.testing.assert_allclose(res[key].numpy(), ref[key], rtol=1e-12, atol=atol)
    ok, fields = observability.kkt_gate(res, fz)
    ok_j, fields_j = jobs.kkt_gate(ref, fz.numpy())
    assert ok == ok_j and ok
    assert fields.keys() == fields_j.keys()
    for key in fields:
        np.testing.assert_allclose(fields[key], fields_j[key], rtol=1e-12)


def test_metrics_logger_drains_what_was_appended():
    log = observability.MetricsLogger()
    assert log.drain() == {}
    rows = [{"vel_err": torch.tensor(0.1 * i), "alive": torch.tensor(i % 2 == 0),
             "count": torch.tensor([i, 2 * i], dtype=torch.int32), "wall": float(i)}
            for i in range(5)]
    for row in rows:
        log.append(row)
    assert len(log) == 5
    out = log.drain()
    assert len(log) == 0
    np.testing.assert_array_equal(out["vel_err"], np.float32([0.1 * i for i in range(5)]))
    assert out["vel_err"].dtype == np.float32 and out["alive"].dtype == np.bool_
    np.testing.assert_array_equal(out["alive"], [True, False, True, False, True])
    np.testing.assert_array_equal(out["count"], np.int32([[i, 2 * i] for i in range(5)]))
    np.testing.assert_array_equal(out["wall"], np.arange(5.0))


def test_profiling_returns_the_jax_keys(tmp_path):
    x = torch.ones(8)
    fn = lambda a: a * 2.0
    with profiling.trace(str(tmp_path)):
        fn(x)
    assert any(p.name.endswith(".pt.trace.json") for p in tmp_path.iterdir())
    st, tp = profiling.stage_timings(fn, x, iters=3), profiling.throughput(fn, x, iters=3,
                                                                          items_per_call=8)
    xj = jnp.ones(8)
    st_j = jprof.stage_timings(jax.jit(lambda a: a * 2.0), xj, iters=3)
    tp_j = jprof.throughput(jax.jit(lambda a: a * 2.0), xj, iters=3, items_per_call=8)
    assert st.keys() == st_j.keys() and tp.keys() == tp_j.keys()
    assert st["budget_ms"] == profiling.MPC_BUDGET_MS == jprof.MPC_BUDGET_MS
    assert profiling.TICK_BUDGET_MS == jprof.TICK_BUDGET_MS
    assert 0.0 <= st["min_ms"] <= st["p50_ms"] <= st["p99_ms"] and tp["items_per_s"] > 0.0


def test_convert_solver_configs_round_trip():
    assert convert.admm_config(jadmm.AdmmConfig()._asdict()) == admm.AdmmConfig()
    assert convert.ipm_config(jipm.IpmConfig()._asdict()) == ipm.IpmConfig()
    assert convert.ipm_config(jipm.PARITY_CONFIG._asdict()) == ipm.PARITY_CONFIG
    assert admm.AdmmConfig()._fields == jadmm.AdmmConfig()._fields
    assert ipm.IpmConfig()._fields == jipm.IpmConfig()._fields
