"""Quaternion / rotation / Euler utilities (port of ``ops/lie.py``).

Conventions as in the JAX package: quaternions ``(w, x, y, z)``, intrinsic
ZYX Euler ``R = Rz(yaw) Ry(pitch) Rx(roll)`` returned as ``[roll, pitch,
yaw]``.  Every function takes any number of leading batch axes (the JAX
functions are unbatched and ``vmap``-ed).  The SE(3)/product-of-exponentials
part of the JAX module is not ported yet (ROADMAP Queue 1, item 13).
"""
from __future__ import annotations

import torch


def _mat3(rows):
    """Nested 3x3 list of (...) tensors -> (..., 3, 3)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(...,4) wxyz quaternion -> (...,3,3) rotation (unnormalized Hamilton form)."""
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    return _mat3([
        [ww + xx - yy - zz, 2.0 * (x * y - w * z), 2.0 * (w * y + x * z)],
        [2.0 * (w * z + x * y), ww - xx + yy - zz, 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (w * x + y * z), ww - xx - yy + zz],
    ])


def quat_to_zyx(q: torch.Tensor) -> torch.Tensor:
    """(...,4) wxyz quaternion -> (...,3) [roll, pitch, yaw]."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def zyx_to_rotmat(rpy: torch.Tensor) -> torch.Tensor:
    """(...,3) [roll, pitch, yaw] -> R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, cp, cy = torch.cos(rpy).unbind(-1)
    sr, sp, sy = torch.sin(rpy).unbind(-1)
    return _mat3([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) wxyz, valid away from trace = -1."""
    tr = 1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = 0.5 * torch.sqrt(torch.clamp(tr, min=1e-12))
    coef = 0.25 / w
    return torch.stack([
        w,
        coef * (R[..., 2, 1] - R[..., 1, 2]),
        coef * (R[..., 0, 2] - R[..., 2, 0]),
        coef * (R[..., 1, 0] - R[..., 0, 1]),
    ], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return _mat3([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 linear solve via the adjugate, batched over leading
    axes (for the well-conditioned leg Jacobians and SPD inertias here)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    inv_det = 1.0 / det
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def rot_x(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _mat3([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _mat3([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rot_z(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _mat3([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def quat_integrate(q: torch.Tensor, omega_body: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a wxyz quaternion by a body-frame angular velocity over dt
    (exponential-map update, Hamilton product q * dq, renormalized)."""
    norm = torch.linalg.vector_norm(omega_body, dim=-1, keepdim=True)
    angle = norm * dt
    axis = omega_body / torch.clamp(norm, min=1e-9)
    half = 0.5 * angle
    w2, v2 = torch.cos(half), torch.sin(half) * axis
    w1, v1 = q[..., :1], q[..., 1:]
    w = w1 * w2 - (v1 * v2).sum(dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    out = torch.cat([w, v], dim=-1)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
