"""Quaternion / rotation / Euler utilities (port of ``ops/lie.py``).

Conventions as in the JAX package: quaternions ``(w, x, y, z)``, intrinsic
ZYX Euler ``R = Rz(yaw) Ry(pitch) Rx(roll)`` returned as ``[roll, pitch,
yaw]``.  Every function takes any number of leading batch axes (the JAX
functions are unbatched and ``vmap``-ed).

The SE(3)/product-of-exponentials half (``exp_so3`` to ``fk_open_chain``)
completes the reference's math library (ref utils/kinematics.py:188-306);
no controller path calls it.  As in the JAX module these are total,
branch-free closed forms: ``exp_se3`` takes the small-angle limit through a
guarded select, so any screw is defined.
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


def exp_so3(omega: torch.Tensor, theta) -> torch.Tensor:
    """Rodrigues' formula for a unit axis: omega (...,3), theta (...) ->
    (...,3,3) (ref kinematics.py:179-186)."""
    K = skew(omega)
    th = torch.as_tensor(theta, dtype=K.dtype, device=K.device)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def rp_to_se3(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation + (...,3) translation -> (...,4,4) homogeneous
    transform (ref kinematics.py:226-235)."""
    lead = torch.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    top = torch.cat([R.expand(lead + (3, 3)), p.expand(lead + (3,))[..., None]], dim=-1)
    bottom = torch.zeros(lead + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a homogeneous transform: (R, p) -> (R^T, -R^T p)
    (ref kinematics.py:188-198)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rp_to_se3(Rt, (-Rt @ T[..., :3, 3:])[..., 0])


def adjoint_rp(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(...,6,6) SE(3) adjoint [[R, 0], [[p]x R, R]] in the reference's
    omega-first twist convention (ref kinematics.py:213-224)."""
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([skew(p) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """(...,6,6) adjoint of a homogeneous transform (ref kinematics.py:200-211)."""
    return adjoint_rp(T[..., :3, :3], T[..., :3, 3])


def screw_axis(omega: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(...,6) screw axis of a revolute joint: unit axis ``omega`` through
    the point ``q`` -> ``[omega, -omega x q]`` (ref kinematics.py:264-273)."""
    omega, q = torch.broadcast_tensors(omega, q)
    return torch.cat([omega, -torch.linalg.cross(omega, q, dim=-1)], dim=-1)


def twist_to_se3(twist: torch.Tensor) -> torch.Tensor:
    """(...,6) twist [omega, v] -> (...,4,4) se(3) matrix [[[omega]x, v], [0, 0]]
    (ref kinematics.py:276-292)."""
    top = torch.cat([skew(twist[..., :3]), twist[..., 3:, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def exp_se3(S: torch.Tensor, theta) -> torch.Tensor:
    """Matrix exponential of the screw ``S*theta``: S (...,6), theta (...)
    -> (...,4,4).  With w = ||omega||,

        R = I + sin(w t)/w [o]x + (1-cos(w t))/w^2 [o]x^2
        p = (I t + (1-cos(w t))/w^2 [o]x + (w t - sin(w t))/w^3 [o]x^2) v,

    and for w < 1e-6 the limit R = I, p = t v by a guarded select, so pure
    translations and non-unit axes are both defined."""
    omega, v = S[..., :3], S[..., 3:]
    theta = torch.as_tensor(theta, dtype=S.dtype, device=S.device)
    w2 = (omega * omega).sum(dim=-1)
    w = torch.sqrt(w2)
    small = w < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)           # guarded divisor
    a = w * theta
    K = skew(omega)
    K2 = K @ K
    sin_c = torch.where(small, theta, torch.sin(a) / ws)[..., None, None]
    cos_c = torch.where(small, 0.5 * theta * theta, (1.0 - torch.cos(a)) / w2)[..., None, None]
    V_c = torch.where(small, theta ** 3 / 6.0, (a - torch.sin(a)) / (w2 * ws))[..., None, None]
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    R = eye + sin_c * K + cos_c * K2
    V = theta[..., None, None] * eye + cos_c * K + V_c * K2
    return rp_to_se3(R, (V @ v[..., None])[..., 0])


def fk_open_chain(home: torch.Tensor, screws: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Product-of-exponentials forward kinematics (ref kinematics.py:294-306):
    ``T = exp(S_0 q_0) ... exp(S_{J-1} q_{J-1}) @ home`` with ``home``
    (...,4,4), ``screws`` (...,J,6) and ``thetas`` (...,J); the J screws
    are folded in order from the identity."""
    T = torch.eye(4, dtype=home.dtype, device=home.device)
    for j in range(screws.shape[-2]):
        T = T @ exp_se3(screws[..., j, :], thetas[..., j])
    return T @ home


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
