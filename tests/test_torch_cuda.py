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

from chip_smoke import (INV_RATIO_BAR, closed_loop_setup, condensed_problem, invariants_ok,
                        inverse_residual, qp_invariants, random_problem)
from pympc_quadruped_tpu_torch.loop import run_ticks
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
