"""Wrapper of the hand-written CUDA Riccati-ADMM kernel.

Replaces the TPU kernel ``pympc_quadruped_tpu/ops/qp/riccati_pallas.py::
_solve_kernel`` (wrapper ``_solve`` :310, ``pl.pallas_call`` :321; entry
``factor_iterate``).  The kernel (``csrc/riccati_admm.cu``, arithmetic in
``csrc/riccati_admm.cuh``) runs one 16-lane group per scenario, several
scenarios per block, with each scenario's factors and iteration state in
shared memory; its source note says what bounds it on the H100 and what the
design does about that.  It reads the batch-major ``(B, ...)`` operands as
they are, with no scratch and no transposes.

:func:`factor_iterate` has the signature and returns of the JAX entry:
batch-major operands in, ``(B,h,12)`` raw U and ``(B,h,20)`` duals out.  On
CPU tensors it runs the plain version (``riccati.lqr_factor`` +
``riccati.iterate``); on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from pympc_quadruped_tpu_torch import _build
from pympc_quadruped_tpu_torch.models.mpc import NUM_INPUT, NUM_STATE, MpcParams
from pympc_quadruped_tpu_torch.ops.qp import riccati

NS, NU, RPS = NUM_STATE, NUM_INPUT, riccati.ROWS_PER_STEP

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

# Launcher argument order (csrc/riccati_admm.cu::riccati_admm_launch).
_ARGS = ("A", "Bd", "hu", "mask", "q2", "mu", "rho", "qx", "xt", "gate",
         "lo", "hi", "u0", "z0", "y0", "U", "Y")


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def operands(Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd, mpc: MpcParams,
             cfg: riccati.RiccatiConfig, init=None, rho_b=None) -> dict:
    """Check the batch-major operands and hand them to the kernel as they
    are (contiguous), with its outputs allocated."""
    B, h = x_t.shape[0], mpc.horizon
    dev = x_t.device
    for name, t, shape in [
        ("Ad", Ad, (B, NS, NS)), ("Bd", Bd, (B, NS, NU)), ("x_t", x_t, (B, NS)),
        ("X_ref", X_ref, (B, h, NS)), ("hu", hu, (B, h, NU)),
        ("m_u", m_u, (B, h, NU)), ("gate", gate, (B, h, RPS)),
        ("l", l, (B, h, RPS)), ("u_bnd", u_bnd, (B, h, RPS)),
    ]:
        _check(name, t, shape, dev)
    if init is not None:
        for name, t, rows in zip(("u0", "z0", "y0"), init, (NU, RPS, RPS)):
            _check(name, t, (B, h, rows), dev)
    if rho_b is not None:
        _check("rho_b", rho_b, (B,), dev)

    f32 = dict(dtype=torch.float32, device=dev)
    ops = {
        "A": Ad.contiguous(), "Bd": Bd.contiguous(),
        "hu": hu.contiguous(), "mask": m_u.contiguous(),
        "q2": (2.0 * mpc.q_diag).to(**f32).contiguous(),
        "mu": mpc.friction_coef.to(**f32).reshape(1).contiguous(),
        "rho": (torch.full((B,), cfg.rho, **f32) if rho_b is None else rho_b.contiguous()),
        "qx": (-2.0 * mpc.q_diag * X_ref).contiguous(), "xt": x_t.contiguous(),
        "gate": gate.contiguous(), "lo": l.contiguous(), "hi": u_bnd.contiguous(),
    }
    if init is None:
        ops["u0"] = torch.zeros((B, h, NU), **f32)
        ops["z0"] = torch.zeros((B, h, RPS), **f32)
        ops["y0"] = torch.zeros((B, h, RPS), **f32)
    else:
        ops["u0"], ops["z0"], ops["y0"] = (a.contiguous() for a in init)
    ops["U"] = torch.empty((B, h, NU), **f32)
    ops["Y"] = torch.empty((B, h, RPS), **f32)
    return ops


def launch(lib, ops: dict, h: int, cfg: riccati.RiccatiConfig, stream=None) -> None:
    """Call ``riccati_admm_launch`` of a bound library on prepared operands;
    raise on a horizon whose two scenarios of a warp do not fit in a block's
    shared memory (the library's ``riccati_admm_max_horizon``) and on a
    non-zero return (a refused launch never runs)."""
    h_max = lib.riccati_admm_max_horizon()
    if h > h_max:
        raise ValueError(
            f"riccati_admm: h={h} does not fit in a block's shared memory on sm_90 "
            f"(the kernel takes h <= {h_max})")
    B = ops["xt"].shape[0]
    for name in _ARGS:
        if not ops[name].is_contiguous():
            raise ValueError(f"{name}: kernel operands must be contiguous")
    rc = lib.riccati_admm_launch(
        *(ops[name].data_ptr() for name in _ARGS),
        B, h, int(cfg.iterations), float(cfg.sigma), float(cfg.alpha), stream,
    )
    if rc != 0:
        raise RuntimeError(f"riccati_admm launch failed: CUDA error {rc}")


def occupancy(lib, h: int) -> dict:
    """What the card keeps resident of the kernel at horizon ``h``: scenarios
    per SM, dynamic shared memory bytes per block, scenarios per block."""
    out = (ctypes.c_int * 3)()
    rc = lib.riccati_admm_occupancy(h, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"riccati_admm occupancy query failed: CUDA error {rc}")
    return {"scenarios_per_sm": out[0], "smem_per_block": out[1],
            "scenarios_per_block": out[2]}


def unpack(ops: dict, h: int):
    """Kernel outputs -> (B,h,12) U, (B,h,20) y."""
    B = ops["xt"].shape[0]
    return ops["U"].reshape(B, h, NU), ops["Y"].reshape(B, h, RPS)


def factor_iterate(Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd, mpc: MpcParams,
                   cfg: riccati.RiccatiConfig, init=None, rho_b=None):
    """Riccati factorization + ``cfg.iterations`` ADMM sweeps.

    Returns (U (B,h,12) raw, swing components included; y (B,h,20)).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if x_t.device.type == "cpu":
        factors = riccati.lqr_factor(Ad, Bd, hu, m_u, mpc)
        return riccati.iterate(factors, Ad, x_t, X_ref, gate, l, u_bnd, mpc,
                               cfg, init, rho_b=rho_b)
    if x_t.device.type != "cuda":
        raise ValueError(f"riccati_cuda: unsupported device {x_t.device}")
    h = mpc.horizon
    ops = operands(Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd, mpc, cfg,
                   init, rho_b)
    lib = _build.load("riccati_admm").lib
    with torch.cuda.device(x_t.device):
        launch(lib, ops, h, cfg, torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return unpack(ops, h)
