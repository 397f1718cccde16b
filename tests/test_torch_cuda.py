"""Card-only tests of the port's CUDA kernel (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false: a CUDA kernel has no
CPU interpret mode (its arithmetic is checked on the CPU by
tests/test_torch_riccati.py through the host build).  This file imports no
JAX, because the machine with the card has none.  tests/conftest.py does
import JAX, so on that machine run it as

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from chip_smoke import random_problem
from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.loop import run_ticks
from pympc_quadruped_tpu_torch.models import Command, Gaits, MpcParams, aliengo
from pympc_quadruped_tpu_torch.ops.qp import riccati, riccati_cuda


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
    mpc, robot, Ad, Bd, x_t, X_ref, table, _ = random_problem(B, 16, seed=3, dev=cuda_device)
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
def test_cuda_closed_loop_goes_through_the_kernel(cuda_device):
    """40 ticks of the h=16 trot at B=64 on the card: one launch per solve
    tick, finite torques, forces on the stance legs only."""
    B, dev = 64, cuda_device
    mpc = tree.to(MpcParams(horizon=16), dev)
    robot = tree.to(tree.tile(aliengo(), B), dev)
    gait = tree.to(tree.tile(Gaits.trotting16(), B), dev)
    cmd = tree.to(tree.tile(Command.trot_forward(1.2), B), dev)
    carry = tree.to(tree.tile(ctrl.init_carry(16), B), dev)
    state = srb_env.default_init_state(robot)
    before = riccati_cuda.LAUNCHES
    carry, state, out = run_ticks(robot, mpc, gait, cmd, carry, state, 0, 40)
    torch.cuda.synchronize()
    assert riccati_cuda.LAUNCHES == before + 2
    assert bool(torch.isfinite(out.torques).all())
    swinging = (out.swing_states != 0).repeat_interleave(3, dim=-1)
    assert float(out.contact_forces[swinging].abs().max()) == 0.0
    assert np.isfinite(state.pos.cpu().numpy()).all()
