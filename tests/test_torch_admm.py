"""The condensed ADMM solver: the port against the JAX package.

- ``admm_fast``'s pieces (cone pattern, row bounds, Ruiz scaling, row
  norms, every ``setup`` output, ``spd_inverse`` at n = 24, 48, 192)
  against JAX on the same numbers.
- ``solve_batch(backend="jnp")`` (the kernels' plain versions) against the
  JAX jnp path and against JAX's four Pallas backends in interpret mode
  (``pl.pallas_call`` patched as tests/test_riccati_pallas.py does), at
  h=2, B=3, cold and warm.
- The CUDA kernels' own per-scenario code (csrc/admm.cuh), built for the CPU
  with the host C++ compiler and driven through ``admm_cuda``'s checks and
  ctypes binding, against the JAX jnp path, at h=2 and h=3 with B=3.
- ``engine.solve_scenarios(solver="admm")`` at h=16 against the JAX engine,
  the f64 active-set oracle (tests/test_riccati.py helpers) and JAX's f64
  KKT certificate (``kkt_residuals_f64``/``kkt_gate``).

Bars.  Solutions are judged on the QP invariants, as the JAX package
judges its own kernels (tests/test_admm_fast.py): the f64 relative cost
difference |c - c_ref| / (|c_ref| + 1) < 2e-5 (test_admm_fast.py:102) and
first-step vertical forces within 2% (clamped at 20 N).  At h=2 and h=3
the QP is well conditioned enough for an elementwise bar too: U and the
duals within 5e-2 N.  On these inputs JAX's own Pallas backends (in
interpret mode) land up to 2.2e-2 N from its jnp path, and the port
(plain or kernel code) up to 2.4e-2 N from JAX's jnp path, at cost
differences below 1e-8: the f32 sweeps reassociate along the QP's weak
directions.  Setup outputs are elementwise at f32 rounding (rtol 1e-5),
except Kinv, a preconditioner whose entries move by ~1e-4 relative
between two f32 recursions; it is judged by its f64 residual
max|Kinv K - I| (within 2x of JAX's), as the spd_inverse cases are.
"""
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pympc_quadruped_tpu import engine as jengine
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.ops.qp import admm_fast as jadmm
from pympc_quadruped_tpu.utils import observability as jobs

from pympc_quadruped_tpu_torch import _build, convert, engine
from pympc_quadruped_tpu_torch.models import default_mpc_params
from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, admm_fast
from test_riccati import _gap, _instance, _oracle
from test_torch_condense import jax_build_qp, qp_inputs

torch.set_num_threads(1)

FZ_MAX = 500.0
COST_BAR, FZ_BAR, U_ATOL = 2e-5, 0.02, 5e-2
PALLAS = ("pallas", "pallas_split", "pallas_fused", "pallas_full")
COLD, WARM = jadmm.AdmmFastConfig(), jadmm.AdmmFastConfig.inloop()


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def _cfg(jcfg):
    """The port's config with the JAX config's values (minus the tile)."""
    return admm_fast.AdmmFastConfig(**{k: getattr(jcfg, k)
                                       for k in admm_fast.AdmmFastConfig._fields})


@functools.cache
def _problem(h, Bn, seed):
    """The same masked condensed QP for both frameworks, plus a warm start
    (a perturbed converged solution and its duals) in problem units."""
    arrays = qp_inputs(Bn, h, seed)
    Hj, gj, mvj = jax_build_qp(arrays, h)
    table = jnp.asarray(arrays[4])
    mpc_j = JMpcParams(horizon=h)
    U, lam = jadmm.solve_batch(Hj, gj, table, FZ_MAX, mpc_j,
                               jadmm.AdmmFastConfig(iterations=200), backend="jnp",
                               return_duals=True)
    noise = np.random.default_rng(seed).normal(scale=5.0, size=U.shape).astype(np.float32)
    warm = (np.asarray(U) * np.asarray(mvj) + noise * np.asarray(mvj), np.asarray(lam))
    return dict(H=np.asarray(Hj), g=np.asarray(gj), table=arrays[4], mv=np.asarray(mvj),
                h=h, warm=warm)


def _jax_solve(p, jcfg, backend, warm):
    args = (jnp.asarray(p["H"]), jnp.asarray(p["g"]), jnp.asarray(p["table"]), FZ_MAX,
            JMpcParams(horizon=p["h"]), jcfg)
    w = None if warm is None else tuple(map(jnp.asarray, warm))
    if backend == "jnp":
        return jadmm.solve_batch(*args, backend="jnp", warm=w, return_duals=True)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return jadmm.solve_batch(*args, backend=backend, warm=w, return_duals=True)
    finally:
        pl.pallas_call = orig


def _port_inputs(p):
    return (torch.tensor(p["H"]), torch.tensor(p["g"]), torch.tensor(p["table"]),
            torch.tensor(FZ_MAX), default_mpc_params(p["h"], device="cpu"))


def _assert_same_solution(p, U, lam, U_ref, lam_ref, elementwise=True):
    U, lam, U_ref, lam_ref = map(_np, (U, lam, U_ref, lam_ref))
    mv = p["mv"]
    Hm, gm = p["H"].astype(np.float64), p["g"].astype(np.float64)
    cost = lambda V: (0.5 * np.einsum("bi,bij,bj->b", V * mv, Hm, V * mv)
                      + np.sum(gm * V * mv, -1))
    c, c_ref = cost(U), cost(U_ref)
    assert np.all(np.isfinite(U)) and np.all(np.isfinite(lam))
    assert np.max(np.abs(c - c_ref) / (np.abs(c_ref) + 1.0)) < COST_BAR, (c, c_ref)
    fz, fz_ref = (V.reshape(len(V), -1, 4, 3)[:, 0, :, 2] for V in (U * mv, U_ref * mv))
    assert np.max(np.abs(fz - fz_ref) / np.maximum(np.abs(fz_ref), 20.0)) < FZ_BAR
    if elementwise:
        np.testing.assert_allclose(U * mv, U_ref * mv, atol=U_ATOL)
        np.testing.assert_allclose(lam, lam_ref, atol=U_ATOL)


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def test_config_presets_match():
    for jcfg in (COLD, WARM):
        cfg = _cfg(jcfg)
        assert cfg == (admm_fast.AdmmFastConfig() if jcfg is COLD
                       else admm_fast.AdmmFastConfig.inloop())


@pytest.mark.parametrize("h", [2, 16])
def test_pattern_bounds_and_norms_match_jax(h):
    mpc = default_mpc_params(h, device="cpu")
    np.testing.assert_array_equal(admm_fast.cone_pattern(mpc.friction_coef, h).numpy(),
                                  np.asarray(jadmm.cone_pattern(jnp.float32(0.7), h)))
    p = _problem(h, 3, 0)
    fz = np.float32([500.0, 300.0, 100.0])
    for fzm in (FZ_MAX, fz):
        ref = jadmm.row_bounds(jnp.asarray(p["table"]), jnp.asarray(fzm), h)
        port = admm_fast.row_bounds(torch.tensor(p["table"]), torch.tensor(fzm), h)
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    srow = jadmm.row_bounds(jnp.asarray(p["table"]), FZ_MAX, h)[0]
    Hs_j, d_j = jadmm.ruiz_scaling(jnp.asarray(p["H"]), srow, None, 2)
    Hs, d = admm_fast.ruiz_scaling(torch.tensor(p["H"]), torch.tensor(np.asarray(srow)),
                                   None, 2)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5)
    np.testing.assert_allclose(Hs.numpy(), np.asarray(Hs_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        admm_fast.pattern_row_norms(mpc.friction_coef, d, h).numpy(),
        np.asarray(jadmm.pattern_row_norms(jnp.float32(0.7), d_j, h)), rtol=1e-5)


@pytest.mark.parametrize("invert", [False, True])
def test_setup_matches_jax(invert):
    """Every setup output at h=2 (K before and Kinv after the inversion)."""
    p = _problem(2, 3, 0)
    ref = jadmm.setup(jnp.asarray(p["H"]), jnp.asarray(p["g"]), jnp.asarray(p["table"]),
                      FZ_MAX, JMpcParams(horizon=2), COLD, invert=invert)
    H, g, table, fz, mpc = _port_inputs(p)
    port = admm_fast.setup(H, g, table, fz, mpc, _cfg(COLD), invert=invert)
    assert type(port).__name__ == type(ref).__name__
    if invert:
        K = np.asarray(jadmm.setup(jnp.asarray(p["H"]), jnp.asarray(p["g"]),
                                   jnp.asarray(p["table"]), FZ_MAX, JMpcParams(horizon=2), COLD,
                                   invert=False).K)
        assert _inverse_residual(port.Kinv, K) <= 2.0 * _inverse_residual(ref.Kinv, K)
    for name in ref._fields[invert:]:
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        scale = np.abs(b[np.isfinite(b)]).max()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


def _spd(n, seed):
    if n == 192:
        p = _problem(16, 2, seed)
        return np.asarray(jadmm.setup(jnp.asarray(p["H"]), jnp.asarray(p["g"]),
                                      jnp.asarray(p["table"]), FZ_MAX, JMpcParams(horizon=16),
                                      COLD, invert=False).K)
    A = np.random.default_rng(seed).normal(size=(2, n, n))
    return (A @ A.transpose(0, 2, 1) / n + 0.1 * np.eye(n)).astype(np.float32)


def _inverse_residual(Kinv, K):
    K64 = np.asarray(K, np.float64)
    return np.max(np.abs(_np(Kinv) @ K64 - np.eye(K64.shape[-1])))


@pytest.mark.parametrize("n", [24, 48, 192])
def test_spd_inverse_matches_jax(n):
    """n = 24 and 48 are well-conditioned random SPD matrices, compared
    elementwise; n = 192 is the h=16 scaled KKT matrix (kappa ~ 1e5)."""
    K = _spd(n, 5)
    ref = jadmm.spd_inverse(jnp.asarray(K), 1)
    port = admm_fast.spd_inverse(torch.tensor(K), 1)
    r_ref, r_port = _inverse_residual(ref, K), _inverse_residual(port, K)
    assert r_port <= 2.0 * r_ref + 1e-6, (r_port, r_ref)
    if n < 192:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
        assert r_port < 1e-4


# ---------------------------------------------------------------------------
# solve_batch: plain version against JAX jnp and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("reference", ["jnp", *PALLAS])
def test_solve_batch_plain_matches_jax(reference, warm):
    p = _problem(2, 3, 0)
    jcfg = WARM if warm else COLD
    w = p["warm"] if warm else None
    U_ref, lam_ref = _jax_solve(p, jcfg, reference, w)
    U, lam = admm_fast.solve_batch(*_port_inputs(p), _cfg(jcfg), backend="jnp",
                                   warm=None if w is None else tuple(map(torch.tensor, w)),
                                   return_duals=True)
    _assert_same_solution(p, U, lam, U_ref, lam_ref)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        admm_fast.solve_batch(*_port_inputs(_problem(2, 3, 0)), backend="pallas_tiled")


# ---------------------------------------------------------------------------
# The kernels' own code, built for the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/admm.cuh compiled for the CPU (csrc/admm_host.cpp)."""
    return _build.build_host("admm_host.cpp", tmp_path_factory.mktemp("admm_host"))


def _host_solve(p, cfg, backend, warm, lib):
    """solve_batch's glue with the kernel entries launched through ``lib``."""
    H, g, table, fz, mpc = _port_inputs(p)
    P0 = admm_fast.cone_pattern(mpc.friction_coef, p["h"])
    w = None if warm is None else tuple(map(torch.tensor, warm))
    if backend == "pallas_full":
        srow, l, u = admm_fast.row_bounds(table, fz, p["h"])
        return admm_cuda.solve_full(H, g, srow, l, u, P0, cfg, warm=w, lib=lib)
    ops = admm_fast.setup(H, g, table, fz, mpc, cfg, invert=backend == "pallas")
    init = None if w is None else admm_fast.warm_init(ops, P0, w)
    entry = {"pallas": admm_cuda.iterate, "pallas_split": admm_cuda.invert_iterate,
             "pallas_fused": admm_cuda.iterate_fused}[backend]
    x, y = entry(ops, P0, cfg, init, lib=lib)
    return x * ops.d, ops.es * y


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("h", [2, 3])
@pytest.mark.parametrize("backend", PALLAS)
def test_kernel_code_on_host_matches_jax(backend, h, warm, host_kernels):
    p = _problem(h, 3, 1)
    jcfg = WARM if warm else COLD
    w = p["warm"] if warm else None
    U_ref, lam_ref = _jax_solve(p, jcfg, "jnp", w)
    before = dict(admm_cuda.LAUNCHES)
    U, lam = _host_solve(p, _cfg(jcfg), backend, w, host_kernels)
    assert admm_cuda.LAUNCHES == before      # host launches are not card launches
    _assert_same_solution(p, U, lam, U_ref, lam_ref)


def test_invert_kernel_code_on_host_h16(host_kernels):
    """The invert kernel's arithmetic at the main path's n = 192: its f64
    residual within 2x of the plain version's on the same K, with the
    kernel's buffers on chip (no device-memory workspace)."""
    assert host_kernels.admm_workspace_floats(admm_cuda._INVERT, 192, 0) == 0
    K = torch.tensor(_spd(192, 7))
    r_kernel = _inverse_residual(admm_cuda.invert_spd(K, lib=host_kernels), K)
    r_plain = _inverse_residual(admm_fast.spd_inverse(K), K)
    assert np.isfinite(r_kernel) and r_kernel <= 2.0 * r_plain, (r_kernel, r_plain)


@pytest.mark.parametrize("n", [84, 204])
def test_invert_kernel_code_on_host_placements(n, host_kernels):
    """n = 84 splits unevenly (84 -> 42 -> 21 -> 10 | 11: W kept transposed
    in a lower-left block that is not square) with the buffer on chip; at
    n = 204 (h = 17) the buffer does not fit and lies in the workspace.
    Same bar as at n = 192."""
    on_chip = n <= 192
    assert (host_kernels.admm_workspace_floats(admm_cuda._INVERT, n, 0)
            == (0 if on_chip else n * (n + 1) + n * 64))
    K = torch.tensor(_spd(n, 7))
    r_kernel = _inverse_residual(admm_cuda.invert_spd(K, lib=host_kernels), K)
    r_plain = _inverse_residual(admm_fast.spd_inverse(K), K)
    assert np.isfinite(r_kernel) and r_kernel <= 2.0 * r_plain, (r_kernel, r_plain)


def test_fused_kernel_workspace_holds_only_newton_schulz_product(host_kernels):
    """At h = 16 the fused kernel's Kinv (the in-place X) and panel live in
    shared memory; its workspace is the n x n Newton-Schulz product R, which
    is read whole while X is still needed and does not fit beside it.  The
    full kernel adds its assembled K."""
    n, m = 192, 320
    assert host_kernels.admm_workspace_floats(admm_cuda._FUSED, n, m) == n * n
    assert host_kernels.admm_workspace_floats(admm_cuda._FULL, n, m) == 2 * n * n


@pytest.mark.parametrize("h", [2, 17])
def test_fused_kernel_code_matches_split_bitwise(h, host_kernels):
    """The fused kernel inverts with the invert kernel's code and sweeps
    with the iterate kernel's, so on the host its (x, y) equal the split
    pipeline's bit for bit: at h = 2 with the buffers on chip, at h = 17
    with X and the panel in the workspace."""
    import chip_smoke

    p = chip_smoke.condensed_problem(2, 3, torch.device("cpu"), h=h)
    cfg = admm_fast.AdmmFastConfig.inloop()
    ops = admm_fast.setup(p.H, p.g, p.table, p.robot.fz_max, p.mpc, cfg, invert=False)
    P0 = admm_fast.cone_pattern(p.mpc.friction_coef, h)
    init = admm_fast.warm_init(ops, P0, p.warm)
    fused = admm_cuda.iterate_fused(ops, P0, cfg, init, lib=host_kernels)
    split = admm_cuda.invert_iterate(ops, P0, cfg, init, lib=host_kernels)
    assert bool(torch.isfinite(fused[0]).all())
    for a, b in zip(fused, split):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def lane_kernels(tmp_path_factory):
    """The invert kernel's code with the card's 256 lanes as host threads
    (tests/admm_lanes.cpp)."""
    return _build.build_host(str(Path(__file__).parent / "admm_lanes.cpp"),
                             tmp_path_factory.mktemp("admm_lanes"))


@pytest.mark.parametrize("ns_iters", [1, 2])
@pytest.mark.parametrize("n", [84, 192])
def test_invert_kernel_code_lanes_match_one_lane(n, ns_iters, lane_kernels, host_kernels):
    """The card's lane split (256 host threads, a barrier for
    __syncthreads) gives bitwise the one-lane host build's Kinv, at the
    uneven split n = 84 and at n = 192, with one and two Newton-Schulz
    steps (the second reloads X from the first's product)."""
    K = torch.tensor(_spd(n, 7)[:1])
    Kinv = admm_cuda.invert_spd(K, ns_iters, lib=lane_kernels)
    assert torch.equal(Kinv, admm_cuda.invert_spd(K, ns_iters, lib=host_kernels))


def test_wrapper_rejects_bad_operands(host_kernels):
    p = _problem(2, 3, 0)
    H, g, table, fz, mpc = _port_inputs(p)
    ops = admm_fast.setup(H, g, table, fz, mpc, _cfg(COLD), invert=False)
    P0 = admm_fast.cone_pattern(mpc.friction_coef, 2)
    with pytest.raises(TypeError, match="float32"):
        admm_cuda.invert_spd(ops.K.double(), lib=host_kernels)
    with pytest.raises(ValueError, match="contiguous"):
        admm_cuda.invert_spd(ops.K.transpose(-1, -2), lib=host_kernels)
    misaligned = torch.empty(ops.K.numel() + 1)[1:].view_as(ops.K)
    with pytest.raises(ValueError, match="aligned"):
        admm_cuda.invert_spd(misaligned, lib=host_kernels)
    with pytest.raises(ValueError, match="shape"):
        admm_cuda.iterate_fused(ops, P0[:, :12], _cfg(COLD), lib=host_kernels)
    with pytest.raises(TypeError, match="AdmmOperands"):
        admm_cuda.iterate(ops, P0, _cfg(COLD), lib=host_kernels)


# ---------------------------------------------------------------------------
# The engine at h=16
# ---------------------------------------------------------------------------

def _engine_args(tick, gait):
    mpc_j, robot_j, x_t, yaw, r_feet, X_ref, table, H64, g64 = _instance(
        tick, horizon=16, gait=gait, vx=0.5, vel_err=0.3)
    arrays = (np.float32(x_t)[None], np.float32([yaw]), np.float32(r_feet)[None],
              np.float32(X_ref)[None], np.float32(table).reshape(1, -1))
    port = (convert.robot_params(convert.as_arrays(robot_j), device="cpu"),
            convert.mpc_params(convert.as_arrays(mpc_j), device="cpu"),
            *map(torch.tensor, arrays))
    return mpc_j, robot_j, arrays, port, table, H64, g64


@pytest.mark.parametrize("gait,tick", [("trotting16", 0), ("trotting16", 19)])
def test_engine_admm_matches_jax_oracle_and_kkt(gait, tick):
    """The engine's default route at h=16 (cold, 56 iterations): f64 oracle
    cost gap < 1e-4 (the h=16 bar of test_riccati.py:137), f64 cost within
    2e-5 of the JAX engine's, JAX's f64 KKT certificate passes, and the
    diagnostics equal JAX's qp_residuals on the same solution.  No
    elementwise bar: at h=16 the cold condensed solve sits a few N from the
    oracle along the QP's weak directions (the reason the JAX package
    added the Riccati path), and the two engines differ there by ~2 N at
    equal cost."""
    mpc_j, robot_j, arrays, port, table, H64, g64 = _engine_args(tick, gait)
    U_j = np.asarray(jengine.solve_scenarios(robot_j, mpc_j, *map(jnp.asarray, arrays),
                                             return_full_horizon=True), np.float64)[0]
    U, diag, lam = engine.solve_scenarios(*port, return_full_horizon=True,
                                          return_diagnostics=True, return_duals=True)
    U64 = _np(U)[0]
    U_star = _oracle(H64, g64, table)
    assert _gap(H64, g64, U64, U_star) < 1e-4
    assert abs(_gap(H64, g64, U64, U_j)) < COST_BAR
    Hj, gj, mvj = jax_build_qp(arrays, 16)
    res = jobs.kkt_residuals_f64(Hj, gj, arrays[4], robot_j.fz_max, U.numpy(), lam.numpy(),
                                 mpc_j)
    ok, fields = jobs.kkt_gate(res, robot_j.fz_max)
    assert ok, fields
    ref = jobs.qp_residuals(Hj, gj, jnp.asarray(arrays[4]), robot_j.fz_max,
                            jnp.asarray(U.numpy()), mpc_j)
    for key in ref:
        np.testing.assert_allclose(diag[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-3)


def test_engine_admm_warm_duals_roundtrip():
    """return_duals/warm on the condensed route: a converged solve fed back
    as the warm start stays put (the receding-horizon contract)."""
    mpc_j, robot_j, arrays, port, table, H64, g64 = _engine_args(0, "trotting16")
    deep = admm_fast.AdmmFastConfig(iterations=300)
    U0, lam0 = engine.solve_scenarios(*port, solver="admm_fast", admm_fast_cfg=deep,
                                      return_full_horizon=True, return_duals=True)
    assert U0.shape == (1, 192) and lam0.shape == (1, 320)
    few = admm_fast.AdmmFastConfig.inloop()._replace(iterations=10)
    U_warm = engine.solve_scenarios(*port, admm_fast_cfg=few, return_full_horizon=True,
                                    warm=(U0, lam0))
    U_star = _oracle(H64, g64, table)
    assert _gap(H64, g64, _np(U_warm)[0], U_star) < 1e-5
