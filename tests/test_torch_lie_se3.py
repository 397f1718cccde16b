"""The SE(3)/product-of-exponentials half of ``ops/lie.py``: the port
against the JAX package, and tests/test_lie.py's SE(3) cases on the port.

Inputs are made with numpy from a seed.  Each of the nine functions runs
on the same float32 inputs in both frameworks, unbatched and with two
leading axes (the JAX function under two ``vmap``s), and is compared
element by element at atol 1e-5 (the outputs are O(1); sin/cos differ by a
few ulp between XLA:CPU and PyTorch).  The independent oracles are
tests/test_lie.py's: ``scipy.linalg.expm`` of the 4x4 se(3) matrix in
float64, a hand-solved planar two-link arm, and the closed-form leg FK of
``ops/kin.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from pympc_quadruped_tpu.ops import lie as jlie

from chip_smoke import leg_screws

from pympc_quadruped_tpu_torch.models import aliengo
from pympc_quadruped_tpu_torch.ops import kin, lie

torch.set_num_threads(1)

TOL = dict(rtol=0.0, atol=1e-5)
LEAD = (2, 3)


def _quat_rot(rng, lead):
    q = rng.normal(size=lead + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jax.jit(jnp.vectorize(jlie.quat_to_rotmat, signature="(4)->(3,3)"))(
        jnp.asarray(q, jnp.float32)))


def _inputs(lead, seed):
    """float32 numpy inputs of every function, with leading axes ``lead``."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=lead + s) * scale).astype(np.float32)
    axis = f(3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    S = f(6)
    # One screw of the batch is a pure translation (omega = 0): the
    # small-angle branch of exp_se3.
    S.reshape(-1, 6)[0, :3] = 0.0
    R = _quat_rot(rng, lead).astype(np.float32)
    p = f(3)
    T = np.zeros(lead + (4, 4), np.float32)
    T[..., :3, :3], T[..., :3, 3], T[..., 3, 3] = R, p, 1.0
    home = T.copy()
    home[..., :3, :3] = _quat_rot(rng, lead)
    return {
        "exp_so3": (axis, rng.uniform(-3.0, 3.0, lead).astype(np.float32)),
        "rp_to_se3": (R, p),
        "inv_se3": (T,),
        "adjoint_rp": (R, p),
        "adjoint_se3": (T,),
        "screw_axis": (axis, f(3)),
        "twist_to_se3": (f(6),),
        "exp_se3": (S, rng.uniform(-1.5, 1.5, lead).astype(np.float32)),
        "fk_open_chain": (home, f(3, 6, scale=0.7), rng.uniform(-1.5, 1.5, lead + (3,))
                          .astype(np.float32)),
    }


@pytest.mark.parametrize("lead", [(), LEAD], ids=["unbatched", "two_leading_axes"])
@pytest.mark.parametrize("name", sorted(_inputs((), 0)))
def test_se3_function_matches_jax(name, lead):
    args = _inputs(lead, seed=len(name))[name]
    fn = getattr(jlie, name)
    for _ in lead:
        fn = jax.vmap(fn)
    want = np.asarray(fn(*(jnp.asarray(a) for a in args)))
    got = getattr(lie, name)(*(torch.from_numpy(a) for a in args))
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float32)


def _expm_se3(S, theta):
    m = np.zeros((4, 4))
    m[:3, :3] = lie.skew(torch.as_tensor(S[:3])).numpy()
    m[:3, 3] = S[3:]
    return scipy.linalg.expm(m * theta)


@pytest.mark.parametrize("trial", range(4))
def test_exp_se3_vs_scipy_expm(trial):
    rng = np.random.default_rng(100 + trial)
    S = rng.normal(size=6)
    theta = float(rng.normal())
    got = lie.exp_se3(_t(S), _t(theta)).numpy()
    np.testing.assert_allclose(got, _expm_se3(S, theta), atol=1e-5)


def test_exp_se3_pure_translation():
    got = lie.exp_se3(_t([0.0, 0.0, 0.0, 1.0, 0.0, 0.0]), _t(0.3)).numpy()
    want = np.eye(4)
    want[0, 3] = 0.3
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_inv_se3_and_rp_roundtrip():
    rng = np.random.default_rng(7)
    R = _quat_rot(rng, (5,))
    T = lie.rp_to_se3(_t(R), _t(rng.normal(size=(5, 3))))
    np.testing.assert_allclose((T @ lie.inv_se3(T)).numpy(), np.tile(np.eye(4), (5, 1, 1)),
                               atol=1e-5)


def test_adjoint_composition():
    """Ad(T1 T2) = Ad(T1) Ad(T2), batched."""
    rng = np.random.default_rng(8)
    T1, T2 = (lie.rp_to_se3(_t(_quat_rot(rng, (4,))), _t(rng.normal(size=(4, 3))))
              for _ in range(2))
    np.testing.assert_allclose(lie.adjoint_se3(T1 @ T2).numpy(),
                               (lie.adjoint_se3(T1) @ lie.adjoint_se3(T2)).numpy(), atol=1e-4)
    np.testing.assert_allclose(lie.adjoint_se3(T1).numpy(),
                               lie.adjoint_rp(T1[:, :3, :3], T1[:, :3, 3]).numpy(), atol=1e-6)


def test_twist_to_se3_layout():
    tw = _t(np.random.default_rng(9).normal(size=(3, 6)))
    m = lie.twist_to_se3(tw)
    np.testing.assert_allclose(m[:, :3, :3].numpy(), lie.skew(tw[:, :3]).numpy(), atol=1e-6)
    np.testing.assert_allclose(m[:, :3, 3].numpy(), tw[:, 3:].numpy(), atol=1e-6)
    assert bool((m[:, 3] == 0.0).all())


def test_fk_open_chain_planar_2link():
    """Planar 2R arm, unit links, joints about +z at x=0 and x=1: the
    three configurations as one batch."""
    z = _t([0.0, 0.0, 1.0])
    screws = torch.stack([lie.screw_axis(z, _t([0.0, 0.0, 0.0])),
                          lie.screw_axis(z, _t([1.0, 0.0, 0.0]))])
    home = torch.eye(4)
    home[0, 3] = 2.0
    q = np.array([(0.0, 0.0), (np.pi / 2, 0.0), (0.3, -0.8)])
    T = lie.fk_open_chain(home.expand(3, 4, 4), screws.expand(3, 2, 6), _t(q)).numpy()
    t1, t12 = q[:, 0], q.sum(axis=1)
    np.testing.assert_allclose(T[:, :3, 3], np.stack(
        [np.cos(t1) + np.cos(t12), np.sin(t1) + np.sin(t12), 0 * t1], axis=1), atol=1e-5)
    np.testing.assert_allclose(T[:, :3, 0], np.stack(
        [np.cos(t12), np.sin(t12), 0 * t1], axis=1), atol=1e-5)


def test_fk_open_chain_matches_leg_fk():
    """PoE FK of each leg (its screws from the robot's geometry, as
    tests/test_lie.py:165 builds them) against the closed-form ``kin`` FK,
    over a batch of random joint angles."""
    robot = aliengo(device="cpu")
    q = _t(np.random.default_rng(10).uniform(-1.0, 1.0, size=(8, 4, 3)))
    p_ref, _ = kin.leg_forward_kinematics(robot, q)
    for leg in range(4):
        home, screws = leg_screws(robot, leg)
        T = lie.fk_open_chain(home.expand(8, 4, 4), screws.expand(8, 3, 6), q[:, leg])
        np.testing.assert_allclose(T[:, :3, 3].numpy(), p_ref[:, leg].numpy(), atol=1e-5)
