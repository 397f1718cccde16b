"""Wrapper of the hand-written CUDA condensed-ADMM kernels (``csrc/admm.cu``,
``csrc/admm_iterate.cu`` and ``csrc/admm_fused.cu``, arithmetic in
``csrc/admm.cuh``).

Each entry has the signature and returns of its JAX counterpart in
``pympc_quadruped_tpu/ops/qp/admm_pallas.py``, without the Pallas tile
arguments (the kernels take any B and any n = 12h, and mask their own
ragged edges):

============================  ===================  ==============================
entry                         kernel               replaces (admm_pallas.py)
============================  ===================  ==============================
:func:`invert_spd`            admm_invert_kernel   ``_invert_kernel`` (:242)
:func:`iterate`               admm_iterate_kernel  ``_kernel`` (:38)
:func:`invert_iterate`        invert, then iterate the split pipeline (:317)
:func:`iterate_fused`         admm_fused_kernel    ``_fused_kernel`` (:374)
:func:`solve_full`            admm_full_kernel     ``_full_kernel`` (:417)
============================  ===================  ==============================

Operands are batch-major and contiguous float32 on one device; a bad one
raises.  On CPU tensors each entry runs its plain version from
:mod:`.admm_fast`; on CUDA tensors it launches the kernel or raises.  The
``lib`` argument launches the kernels of another binding of the same C
launchers instead (the CPU tests pass the host build of ``admm.cuh``).
:data:`LAUNCHES` counts the CUDA launches of each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from pympc_quadruped_tpu_torch import _build
from pympc_quadruped_tpu_torch.ops.qp import admm_fast
from pympc_quadruped_tpu_torch.ops.qp.admm_fast import AdmmKktOperands, AdmmOperands

#: CUDA launches of each kernel since import (or since a caller reset them).
LAUNCHES = {"invert_spd": 0, "iterate": 0, "iterate_fused": 0, "solve_full": 0}

# Kernel ids of admm_workspace_floats (csrc/admm.cuh, enum Kernel).
_INVERT, _ITERATE, _FUSED, _FULL = range(4)


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel operands must be contiguous")


def _check_aligned(name, t):
    """The inverting kernels read K's (the full kernel H's) rows 16 bytes at
    a time, and the iterate kernel brings its operands to shared memory by
    16-byte bulk copies."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels need a 16-byte aligned start")


def _check_n(lib, n):
    """Refuse an n beyond the kernels' Schur recursion (admm::MAX_N, which
    every library of csrc/admm.cuh exports)."""
    max_n = lib.admm_max_n()
    if n > max_n:
        raise ValueError(f"n={n}: the kernels invert at most {max_n} x {max_n} matrices")


def _dims(lib, n, m):
    if n % 12 or 3 * m != 5 * n:
        raise ValueError(f"n={n}, m={m}: expected n = 12h variables and m = 20h cone rows")
    _check_n(lib, n)


def _target(t: torch.Tensor, lib, source="admm"):
    """(library, stream) to launch with, or None for the plain version; the
    CUDA library is the one built from ``csrc/<source>.cu``."""
    stream = torch.cuda.current_stream(t.device).cuda_stream if t.is_cuda else None
    if lib is not None:
        return lib, stream
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"admm_cuda: unsupported device {t.device}")
    return _build.load(source).lib, stream


def _run(t: torch.Tensor, name: str, fn, *args) -> None:
    """Call a C launcher; raise on a non-zero return (a refused launch
    never runs) and count the launch when it went to the card."""
    if t.is_cuda:
        with torch.cuda.device(t.device):
            rc = fn(*args)
    else:
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    if t.is_cuda:
        LAUNCHES[name] += 1


def invert_occupancy(lib, n: int) -> dict:
    """What the card keeps resident of the invert kernel at ``n``: blocks
    (one scenario each) per SM and dynamic shared memory bytes per block."""
    out = (ctypes.c_int * 2)()
    rc = lib.admm_invert_occupancy(n, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"admm_invert_kernel occupancy query failed: CUDA error {rc}")
    return {"blocks_per_sm": out[0], "smem_per_block": out[1]}


def iterate_config(lib, B: int, n: int, m: int) -> dict:
    """How the iterate kernel launches at (B, n, m): threads a block,
    blocks (persistent, at most one per SM, at n <= 192), dynamic shared
    memory bytes a block, and blocks resident per SM."""
    out = (ctypes.c_int * 4)()
    rc = lib.admm_iterate_config(B, n, m, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"admm_iterate_kernel configuration query failed: CUDA error {rc}")
    return {"threads": out[0], "grid": out[1], "smem_per_block": out[2],
            "blocks_per_sm": out[3]}


def fused_config(lib, kernel: str, n: int, m: int) -> dict:
    """How the fused (``kernel="fused"``) or full (``"full"``) kernel
    launches at (n, m): threads a block, dynamic shared memory bytes a
    block, blocks resident per SM, and device-memory workspace floats per
    scenario."""
    kid = {"fused": _FUSED, "full": _FULL}[kernel]
    out = (ctypes.c_int * 3)()
    rc = lib.admm_fused_config(kid, n, m, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"admm_{kernel}_kernel configuration query failed: CUDA error {rc}")
    return {"threads": out[0], "smem_per_block": out[1], "blocks_per_sm": out[2],
            "workspace_floats": lib.admm_workspace_floats(kid, n, m)}


def _workspace(lib, kernel, B, n, m, device) -> torch.Tensor:
    return torch.empty(B * lib.admm_workspace_floats(kernel, n, m),
                       dtype=torch.float32, device=device)


def invert_spd(K: torch.Tensor, ns_iters: int = 1, lib=None) -> torch.Tensor:
    """Batched SPD inverse of (B,n,n) K: the Schur recursion plus
    ``ns_iters`` Newton-Schulz steps (``admm_fast.spd_inverse``)."""
    B, n = K.shape[0], K.shape[-1]
    _check("K", K, (B, n, n), K.device)
    target = _target(K, lib)
    if target is None:
        return admm_fast.spd_inverse(K, ns_iters)
    lib, stream = target
    _check_n(lib, n)
    _check_aligned("K", K)
    Kinv = torch.empty_like(K)
    ws = _workspace(lib, _INVERT, B, n, 0, K.device)
    _run(K, "invert_spd", lib.admm_invert_launch,
         K.data_ptr(), Kinv.data_ptr(), ws.data_ptr(), B, n, int(ns_iters), stream)
    return Kinv


def _iter_operands(lib, ops, mat_name, P0, init):
    """Checked operands (q .. y0, then the outputs x (B,n), y (B,m)) of the
    iterate and fused kernels.  The caller holds them until the launch has
    been enqueued: a pointer alone does not keep a tensor alive."""
    B, n = ops.q.shape
    m = ops.es.shape[-1]
    _dims(lib, n, m)
    dev = ops.q.device
    _check(mat_name, ops[0], (B, n, n), dev)
    for name in ("q", "d"):
        _check(name, getattr(ops, name), (B, n), dev)
    for name in ("es", "rho", "l", "u"):
        _check(name, getattr(ops, name), (B, m), dev)
    _check("P0", P0, (m, n), dev)
    if init is None:
        init = (torch.zeros((B, n), dtype=torch.float32, device=dev),
                torch.zeros((B, m), dtype=torch.float32, device=dev),
                torch.zeros((B, m), dtype=torch.float32, device=dev))
    for name, t, w in zip(("x0", "z0", "y0"), init, (n, m, m)):
        _check(name, t, (B, w), dev)
    x = torch.empty((B, n), dtype=torch.float32, device=dev)
    y = torch.empty((B, m), dtype=torch.float32, device=dev)
    return (ops.q, ops.d, ops.es, ops.rho, ops.l, ops.u, P0, *init, x, y), (B, n, m)


def iterate(ops: AdmmOperands, P0: torch.Tensor, cfg: admm_fast.AdmmFastConfig,
            init=None, lib=None):
    """``cfg.iterations`` ADMM sweeps with Kinv held on chip.  Returns the
    SCALED (x (B,n), y (B,m)), like ``admm_fast.iterate_jnp``; ``init`` is
    an optional scaled warm start (x0, z0, y0).  P0 must be
    ``admm_fast.cone_pattern``: the kernel reads mu from P0[0, 2] and
    applies the pattern block by block.  Kinv and the vectors the kernel
    copies in (q, d, es, rho, l, u, x0, z0, y0) must start 16-byte
    aligned."""
    if not isinstance(ops, AdmmOperands):
        raise TypeError(
            "iterate needs AdmmOperands (setup(invert=True)); got "
            f"{type(ops).__name__}: route it to iterate_fused()"
        )
    target = _target(ops.q, lib, "admm_iterate")
    if target is None:
        return admm_fast.iterate_jnp(ops, P0, cfg, init)
    lib, stream = target
    args, (B, n, m) = _iter_operands(lib, ops, "Kinv", P0, init)
    names = ("Kinv", "q", "d", "es", "rho", "l", "u", "P0", "x0", "z0", "y0")
    for name, t in zip(names, (ops.Kinv, *args)):
        if name != "P0":
            _check_aligned(name, t)
    _run(ops.q, "iterate", lib.admm_iterate_launch,
         *(t.data_ptr() for t in (ops.Kinv, *args)),
         B, n, m, int(cfg.iterations), float(cfg.sigma), float(cfg.alpha), stream)
    return args[-2], args[-1]


def _kkt_operands(ops, name):
    if not isinstance(ops, AdmmKktOperands):
        raise TypeError(
            f"{name} needs AdmmKktOperands (setup(invert=False)); got "
            f"{type(ops).__name__}"
        )


def invert_iterate(ops: AdmmKktOperands, P0: torch.Tensor, cfg: admm_fast.AdmmFastConfig,
                   init=None, lib=None):
    """The split two-kernel solve (the default on the card): the invert
    kernel, then the iterate kernel on its Kinv.  Returns SCALED (x, y)."""
    _kkt_operands(ops, "invert_iterate")
    Kinv = invert_spd(ops.K, cfg.newton_schulz_iters, lib=lib)
    return iterate(AdmmOperands(Kinv, *ops[1:]), P0, cfg, init, lib=lib)


def iterate_fused(ops: AdmmKktOperands, P0: torch.Tensor, cfg: admm_fast.AdmmFastConfig,
                  init=None, lib=None):
    """Invert and iterate in one launch; Kinv lands in shared memory and
    never goes back to device memory.  Returns SCALED (x, y), bit for bit
    :func:`invert_iterate`'s."""
    _kkt_operands(ops, "iterate_fused")
    target = _target(ops.q, lib, "admm_fused")
    if target is None:
        Kinv = admm_fast.spd_inverse(ops.K, cfg.newton_schulz_iters)
        return admm_fast.iterate_jnp(AdmmOperands(Kinv, *ops[1:]), P0, cfg, init)
    lib, stream = target
    args, (B, n, m) = _iter_operands(lib, ops, "K", P0, init)
    _check_aligned("K", ops.K)
    ws = _workspace(lib, _FUSED, B, n, m, ops.q.device)
    _run(ops.q, "iterate_fused", lib.admm_fused_launch,
         *(t.data_ptr() for t in (ops.K, *args, ws)),
         B, n, m, int(cfg.iterations), float(cfg.sigma), float(cfg.alpha),
         int(cfg.newton_schulz_iters), stream)
    return args[-2], args[-1]


def solve_full(H, g, srow, l, u, P0: torch.Tensor, cfg: admm_fast.AdmmFastConfig,
               warm=None, lib=None):
    """One-kernel solve from the raw masked cost H (B,n,n), g (B,n) and the
    row data srow, l, u (B,m) of ``admm_fast.row_bounds``: Ruiz scaling,
    K assembly, inversion, sweeps and unscaling.  Returns UNSCALED
    ``(U (B,n), lam (B,m))``.  ``warm`` is the unscaled ``(U0, lam0)``;
    zeros are exactly the cold start."""
    target = _target(g, lib, "admm_fused")
    if target is None:
        return admm_fast.solve_full(H, g, srow, l, u, P0, cfg, warm)
    lib, stream = target
    B, n = g.shape
    m = srow.shape[-1]
    _dims(lib, n, m)
    dev = g.device
    _check("H", H, (B, n, n), dev)
    _check_aligned("H", H)
    _check("g", g, (B, n), dev)
    for name, t in (("srow", srow), ("l", l), ("u", u)):
        _check(name, t, (B, m), dev)
    _check("P0", P0, (m, n), dev)
    if warm is None:
        warm = (torch.zeros((B, n), dtype=torch.float32, device=dev),
                torch.zeros((B, m), dtype=torch.float32, device=dev))
    U0, lam0 = warm
    _check("U0", U0, (B, n), dev)
    _check("lam0", lam0, (B, m), dev)
    U = torch.empty((B, n), dtype=torch.float32, device=dev)
    lam = torch.empty((B, m), dtype=torch.float32, device=dev)
    ws = _workspace(lib, _FULL, B, n, m, dev)
    _run(g, "solve_full", lib.admm_full_launch,
         *(t.data_ptr() for t in (H, g, srow, l, u, U0, lam0, P0, U, lam, ws)),
         B, n, m, int(cfg.iterations), float(cfg.sigma), float(cfg.alpha),
         int(cfg.newton_schulz_iters), int(cfg.ruiz_iters), float(cfg.rho),
         float(cfg.rho_eq), stream)
    return U, lam
