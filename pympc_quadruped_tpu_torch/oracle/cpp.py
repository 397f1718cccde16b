"""ctypes bridge to the native C++ QP oracle (port of ``oracle/cpp.py``).

``csrc/qp_oracle.cc`` is the package's own copy of ``native/qp_oracle.cc``:
a float64 interior-point solve of the masked condensed QP with its own
Cholesky, no BLAS.  It is built with the host C++ compiler at first use
(:func:`.._build.build_host`, ``-O2 -std=c++17``) into the git-ignored
``_build/host/``; a failed build raises.  Used to cross-certify the torch
float64 oracle (:mod:`.npref`) with an implementation that shares none of
its code.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pympc_quadruped_tpu_torch import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.build_host("qp_oracle.cc", _build.BUILD_DIR / "host")


def _host_f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device="cpu").contiguous()


def solve_qp(H, g, gait_table, mu=0.7, fz_max=500.0, max_iter=60, tol=1e-9):
    """Solve the masked condensed QP in native float64.

    Args mirror :func:`.npref.solve_qp_kkt`: the unmasked (12h,12h) ``H``
    and (12h,) ``g``, the (4h,) stance table, cone ``mu`` and ``fz_max``,
    as CPU tensors or numpy arrays.  Returns ``(U, kkt)`` as CPU float64
    tensors: the (12h,) solution (swing entries exactly 0 up to the
    identity pinning) and the (dual, primal, complementarity) residuals.
    Raises ``torch.linalg.LinAlgError`` where the normal matrix is not SPD.
    """
    H, g, table = _host_f64(H), _host_f64(g), _host_f64(gait_table)
    n = g.shape[0]
    horizon = n // 12
    if H.shape != (n, n) or table.shape != (4 * horizon,) or n != 12 * horizon:
        raise ValueError(f"H {tuple(H.shape)}, g {tuple(g.shape)} and the table "
                         f"{tuple(table.shape)} are not one (12h,12h), (12h,), (4h,) problem")
    U = torch.zeros(n, dtype=torch.float64)
    kkt = torch.zeros(3, dtype=torch.float64)
    rc = _lib().qp_oracle_solve(
        horizon, H.data_ptr(), g.data_ptr(), table.data_ptr(),
        float(mu), float(fz_max), int(max_iter), float(tol),
        U.data_ptr(), kkt.data_ptr(),
    )
    if rc == 2:
        raise torch.linalg.LinAlgError("native oracle: normal matrix not SPD")
    return U, kkt
