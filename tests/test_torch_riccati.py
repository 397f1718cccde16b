"""The sparse Riccati-ADMM solve: the port against the JAX package.

- The plain PyTorch ``lqr_factor`` + ``iterate`` (the kernel's plain
  version) against the JAX jnp path and against the JAX Pallas kernel in
  interpret mode, patched exactly as tests/test_riccati_pallas.py does, at
  h=3 with B=2: cold, warm and per-scenario rho.  Bar atol 2e-2 N, the
  one the JAX package set for its kernel against its jnp path
  (test_riccati_pallas.py:77): exact-f32 FMA chains against matmul
  reductions differ by reassociation noise only.
- The CUDA kernel's own per-scenario code (csrc/riccati_admm.cuh), built
  for the CPU with the host C++ compiler (one lane per scenario) and
  driven through the wrapper's batch-major operands and ctypes binding,
  against the same JAX references and bar, also at B=1 and B=33.
- ``engine.solve_scenarios(solver="riccati")`` at h=16 against the JAX
  engine and the f64 oracle, with the bars of test_riccati.py:124-142.

The card-only kernel tests live in tests/test_torch_cuda.py, which imports
no JAX: the machine with the card has none.
"""
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pympc_quadruped_tpu import engine as jengine
from pympc_quadruped_tpu.ops.qp import riccati as jriccati
from pympc_quadruped_tpu.ops.qp import riccati_pallas

from pympc_quadruped_tpu_torch import _build, convert, engine
from pympc_quadruped_tpu_torch.models import aliengo
from pympc_quadruped_tpu_torch.ops.qp import riccati, riccati_cuda
from test_riccati import _gap, _instance, _oracle
from test_riccati_pallas import _problem

torch.set_num_threads(1)

ATOL = 2e-2

# name -> (B, h, iterations, seed).  One shape and iteration count for all
# three, so the Pallas kernel's interpret-mode program (~1.5 min to compile
# on the CPU) is compiled once per process and reused.
CASES = {
    "cold": (2, 3, 4, 0),
    "warm": (2, 3, 4, 5),
    "rho": (2, 3, 4, 9),
}


def _t(a):
    return torch.tensor(np.asarray(a))


def _case(name, shape=None):
    """The JAX problem, its step data, and the same numbers for the port;
    ``shape`` (B, h, iterations, seed) overrides the case's own."""
    B, h, iters, seed = shape or CASES[name]
    cfg_kw = dict(iterations=iters, rho=4.0e-4) if name == "rho" else dict(iterations=iters)
    jcfg, cfg = jriccati.RiccatiConfig(**cfg_kw), riccati.RiccatiConfig(**cfg_kw)
    mpc_j, robot_j, Ad, Bd, x_t, X_ref, table = _problem(B, h, seed=seed)
    rho_b = jnp.asarray([4.0e-4, 1.5e-3], jnp.float32) if name == "rho" else None
    m_u, gate = jriccati.step_gating(table, h)
    l, u_bnd = jriccati.step_bounds(table, robot_j.fz_max, h)
    hu = jriccati.input_cost_diag(m_u, mpc_j, jcfg, rho_b=rho_b)
    init = None
    if name == "warm":
        init = (jnp.asarray(np.random.default_rng(1).normal(size=(B, h, 12)), jnp.float32),
                jnp.zeros((B, h, 20), jnp.float32), jnp.zeros((B, h, 20), jnp.float32))
    jargs = (Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd)
    mpc = convert.mpc_params(convert.as_arrays(mpc_j), device="cpu")
    port = dict(args=tuple(_t(a) for a in jargs), mpc=mpc, cfg=cfg,
                init=None if init is None else tuple(_t(a) for a in init),
                rho_b=None if rho_b is None else _t(rho_b))
    return dict(jargs=jargs, mpc_j=mpc_j, jcfg=jcfg, init=init, rho_b=rho_b), port


def _jax_jnp(j):
    Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd = j["jargs"]
    fac = jriccati.lqr_factor(Ad, Bd, hu, m_u, j["mpc_j"])
    return jriccati.iterate(fac, Ad, x_t, X_ref, gate, l, u_bnd, j["mpc_j"], j["jcfg"],
                            j["init"], rho_b=j["rho_b"])


def _jax_pallas_interpret(j):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return riccati_pallas.factor_iterate(*j["jargs"], j["mpc_j"], j["jcfg"], j["init"],
                                             rho_b=j["rho_b"])
    finally:
        pl.pallas_call = orig


def _port_plain(p):
    Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd = p["args"]
    fac = riccati.lqr_factor(Ad, Bd, hu, m_u, p["mpc"])
    return riccati.iterate(fac, Ad, x_t, X_ref, gate, l, u_bnd, p["mpc"], p["cfg"],
                           p["init"], rho_b=p["rho_b"])


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/riccati_admm.cuh compiled for the CPU (csrc/riccati_admm_host.cpp)."""
    return _build.build_host("riccati_admm_host.cpp", tmp_path_factory.mktemp("host_kernel"))


def _port_host_kernel(p, lib):
    ops = riccati_cuda.operands(*p["args"], p["mpc"], p["cfg"], p["init"], rho_b=p["rho_b"])
    riccati_cuda.launch(lib, ops, p["mpc"].horizon, p["cfg"])
    return riccati_cuda.unpack(ops, p["mpc"].horizon)


def _assert_close(port_out, jax_out):
    for a, b in zip(port_out, jax_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_plain_matches_jax(case, reference):
    j, p = _case(case)
    ref = _jax_jnp(j) if reference == "jnp" else _jax_pallas_interpret(j)
    _assert_close(_port_plain(p), ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_code_on_host_matches_jax(case, host_kernel):
    j, p = _case(case)
    _assert_close(_port_host_kernel(p, host_kernel), _jax_jnp(j))


@pytest.mark.parametrize("B", [1, 33])
def test_kernel_code_on_host_odd_batch_matches_jax(B, host_kernel):
    """The kernel's arithmetic on batches that leave a half-warp (B=1) or a
    block partly idle (B=33) on the card, against JAX jnp at h=3."""
    j, p = _case("cold", shape=(B, 3, 10, 21 + B))
    _assert_close(_port_host_kernel(p, host_kernel), _jax_jnp(j))


def test_wrapper_rejects_horizon_beyond_shared_memory(host_kernel):
    """A horizon whose scenario does not fit in one block's shared memory
    raises with a message; nothing falls back."""
    assert host_kernel.riccati_admm_max_horizon() >= 16
    with pytest.raises(ValueError, match="shared memory"):
        riccati_cuda.launch(host_kernel, {}, 200, riccati.RiccatiConfig())


def test_kernel_code_sixteen_lanes_matches_one_lane(host_kernel, tmp_path):
    """The card's lane split (tests/riccati_admm_lanes.cpp: 16 host threads
    a scenario, a barrier for the warp barrier) gives bitwise the one-lane
    host build's U and duals at h=16, warm-started with per-scenario rho."""
    lanes = _build.build_host(str(Path(__file__).parent / "riccati_admm_lanes.cpp"), tmp_path)
    mpc_j, robot_j, Ad, Bd, x_t, X_ref, table = _problem(3, 16, seed=4)
    mpc = convert.mpc_params(convert.as_arrays(mpc_j), device="cpu")
    cfg = riccati.RiccatiConfig.inloop()._replace(iterations=5)
    Ad, Bd, x_t, X_ref, table = map(_t, (Ad, Bd, x_t, X_ref, table))
    m_u, gate = riccati.step_gating(table, 16)
    l, u_bnd = riccati.step_bounds(table, aliengo(device="cpu").fz_max, 16)
    rho_b = cfg.rho * riccati.rho_scale_from_Bd(Bd, mpc)
    hu = riccati.input_cost_diag(m_u, mpc, cfg, rho_b=rho_b)
    u0 = torch.tensor(np.random.default_rng(2).normal(scale=20.0, size=(3, 16, 12)),
                      dtype=torch.float32)
    p = dict(args=(Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd), mpc=mpc, cfg=cfg,
             init=(u0, torch.zeros_like(gate), torch.zeros_like(gate)), rho_b=rho_b)
    for a, b in zip(_port_host_kernel(p, lanes), _port_host_kernel(p, host_kernel)):
        assert torch.equal(a, b)


def test_kernel_code_on_host_h16_matches_plain(host_kernel):
    """At the main path's horizon, the kernel's arithmetic and the plain
    version agree far inside the on-card bars (first-step fz within 2%,
    U within 1 N) on a ragged batch."""
    mpc_j, robot_j, Ad, Bd, x_t, X_ref, table = _problem(5, 16, seed=3)
    mpc = convert.mpc_params(convert.as_arrays(mpc_j), device="cpu")
    cfg = riccati.RiccatiConfig.inloop()
    Ad, Bd, x_t, X_ref, table = map(_t, (Ad, Bd, x_t, X_ref, table))
    m_u, gate = riccati.step_gating(table, 16)
    l, u_bnd = riccati.step_bounds(table, aliengo(device="cpu").fz_max, 16)
    rho_b = cfg.rho * riccati.rho_scale_from_Bd(Bd, mpc)
    hu = riccati.input_cost_diag(m_u, mpc, cfg, rho_b=rho_b)
    p = dict(args=(Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd), mpc=mpc, cfg=cfg,
             init=None, rho_b=rho_b)
    U_k, _ = _port_host_kernel(p, host_kernel)
    U_p, _ = _port_plain(p)
    fz_k, fz_p = U_k[:, 0, 2::3], U_p[:, 0, 2::3]
    assert float(((fz_k - fz_p).abs() / fz_p.abs().clamp(min=20.0)).max()) < 0.02
    assert float((U_k - U_p).abs().max()) < 1.0


def _engine_inputs(tick, gait):
    mpc_j, robot_j, x_t, yaw, r_feet, X_ref, table, H64, g64 = _instance(
        tick, horizon=16, gait=gait, vx=0.5, vel_err=0.3)
    arrays = (np.float32(x_t)[None], np.float32([yaw]), np.float32(r_feet)[None],
              np.float32(X_ref)[None], np.float32(table).reshape(1, -1))
    return mpc_j, robot_j, arrays, table, H64, g64


@pytest.mark.parametrize("gait,tick", [("trotting16", 0), ("trotting16", 19),
                                       ("jumping16", 7)])
def test_engine_riccati_matches_jax_and_oracle(gait, tick):
    """The engine's riccati route at h=16: the bars of test_riccati.py:137-142
    against the f64 oracle (cost gap < 1e-4, U within 5 N, first-step fz
    within 5%), and first-step forces within 1 N of the JAX engine."""
    mpc_j, robot_j, arrays, table, H64, g64 = _engine_inputs(tick, gait)
    U_star = _oracle(H64, g64, table)
    U_j = np.asarray(jengine.solve_scenarios(
        robot_j, mpc_j, *map(jnp.asarray, arrays), solver="riccati",
        return_full_horizon=True), np.float64)[0]
    U = engine.solve_scenarios(
        convert.robot_params(convert.as_arrays(robot_j), device="cpu"),
        convert.mpc_params(convert.as_arrays(mpc_j), device="cpu"),
        *map(torch.tensor, arrays), solver="riccati", return_full_horizon=True,
    ).numpy().astype(np.float64)[0]
    assert _gap(H64, g64, U, U_star) < 1e-4
    assert np.max(np.abs(U - U_star)) < 5.0
    fz, fz_star = U.reshape(16, 4, 3)[0, :, 2], U_star.reshape(16, 4, 3)[0, :, 2]
    assert np.max(np.abs(fz - fz_star) / np.maximum(np.abs(fz_star), 20.0)) < 0.05
    np.testing.assert_allclose(U[:12], U_j[:12], atol=1.0)


def test_engine_warm_duals_roundtrip():
    """return_duals/warm: a converged solve fed back as the warm start stays
    put (the receding-horizon contract the controller relies on)."""
    mpc_j, robot_j, arrays, table, H64, g64 = _engine_inputs(0, "trotting16")
    args = (convert.robot_params(convert.as_arrays(robot_j), device="cpu"),
            convert.mpc_params(convert.as_arrays(mpc_j), device="cpu"), *map(torch.tensor, arrays))
    deep = riccati.RiccatiConfig(iterations=300)
    U0, lam0 = engine.solve_scenarios(*args, solver="riccati", riccati_cfg=deep,
                                      return_full_horizon=True, return_duals=True)
    assert U0.shape == (1, 192) and lam0.shape == (1, 320)
    few = riccati.RiccatiConfig.inloop()._replace(iterations=10)
    U_warm = engine.solve_scenarios(*args, solver="riccati", riccati_cfg=few,
                                    return_full_horizon=True, warm=(U0, lam0))
    U_star = _oracle(H64, g64, table)
    assert _gap(H64, g64, U_warm[0].numpy().astype(np.float64), U_star) < 1e-5


def test_wrapper_rejects_bad_operands():
    _, p = _case("cold")
    Ad, *rest = p["args"]
    with pytest.raises(TypeError, match="float32"):
        riccati_cuda.operands(Ad.double(), *rest, p["mpc"], p["cfg"])
    with pytest.raises(ValueError, match="shape"):
        riccati_cuda.operands(Ad[:, :12], *rest, p["mpc"], p["cfg"])
