"""Batched full-order rigid-body dynamics of the fixed quadruped tree (port
of ``ops/rbd.py``).

A floating trunk with four identical hip(x)-thigh(y)-calf(y) chains, the
tree the JAX package's generated MuJoCo model has, body for body.  Spatial
(Plücker) algebra in body coordinates, Featherstone conventions with
(angular, linear) ordering: CRBA for the 18x18 mass matrix, RNEA for the
bias forces, and an 18x18 Cholesky solve for the accelerations.

Layout: the JAX module maps one leg's chain over the four legs with
``vmap`` and the scenarios with an outer ``vmap``; here the four legs are a
tensor axis (``(..., 4, 3, ...)``: leg, then link hip/thigh/calf) and every
function takes any leading scenario axes on the model and the state alike.

Generalized velocity (internal): ``u = [omega_b (3, body frame), v_b (3,
body frame), qd (12)]``; :func:`u_from_mujoco` / :func:`qacc_to_mujoco`
convert from and to MuJoCo's free-joint ``[v_world, omega_body]``.

The solve in :func:`forward_dynamics` is ``cholesky_ex`` and two
``solve_triangular`` in float32, as JAX's ``cholesky`` + ``cho_solve``:
``cholesky_solve`` and ``solve_ex`` break the capture of the rollout tick
in a CUDA graph (tools/graph_capture_probe.py), and ``cholesky_ex`` reports
a failed factorization in ``info`` without a host read.  Where it failed
(a mass matrix that is not positive definite, or a non-finite state) the
scenario's accelerations are NaN, as JAX's are.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.utils import profiling


@dataclass
class RbdModel:
    """Dynamic parameters (float32), with any leading scenario axes.

    Leg-indexed fields follow the leg order FL, FR, RL, RR, then the link
    order hip, thigh, calf."""

    # trunk
    trunk_mass: torch.Tensor      # (...)
    trunk_com: torch.Tensor       # (...,3)
    trunk_inertia: torch.Tensor   # (...,3,3) about the COM, trunk axes
    # per-leg link chain
    link_mass: torch.Tensor       # (...,4,3)
    link_com: torch.Tensor        # (...,4,3,3) in the link frame
    link_inertia: torch.Tensor    # (...,4,3,3,3) about the COM, link axes
    joint_origin: torch.Tensor    # (...,4,3,3) joint origin in the parent frame
    joint_axis: torch.Tensor      # (...,4,3,3) hinge axis in the child frame
    foot_offset: torch.Tensor     # (...,4,3) foot point in the calf frame
    armature: torch.Tensor        # (...,4,3) reflected rotor inertia per hinge
    damping: torch.Tensor         # (...,4,3) viscous joint damping
    gravity: torch.Tensor         # (...) positive magnitude


# ---------------------------------------------------------------------------
# Spatial-algebra helpers ((angular, linear) ordering, body coordinates)
# ---------------------------------------------------------------------------

def _hat(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _mT(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def _xmat(E: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """6x6 Plücker motion transform parent -> child for a child frame at
    origin ``t`` (parent coords) with rotation ``E`` (parent coords to child
    coords): m_child = X @ m_parent."""
    Z = torch.zeros_like(E)
    top = torch.cat([E, Z], dim=-1)
    bot = torch.cat([-(E @ _hat(t)), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _spatial_inertia(mass: torch.Tensor, com: torch.Tensor, I_com: torch.Tensor):
    """6x6 spatial inertia about the body-frame origin; ``mass`` (...)."""
    ch = _hat(com)
    m = mass[..., None, None]
    I_o = I_com - m * (ch @ ch)
    eye = torch.eye(3, dtype=ch.dtype, device=ch.device)
    top = torch.cat([I_o, m * ch], dim=-1)
    bot = torch.cat([-(m * ch), m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _cross_motion(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product a x b for 6-vectors (w, v)."""
    aw, av = a[..., :3], a[..., 3:]
    bw, bv = b[..., :3], b[..., 3:]
    return torch.cat([_cross3(aw, bw), _cross3(aw, bv) + _cross3(av, bw)], dim=-1)


def _cross_force(a: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product a x* f for motion a = (w, v), force f = (n, F)."""
    aw, av = a[..., :3], a[..., 3:]
    n, F = f[..., :3], f[..., 3:]
    return torch.cat([_cross3(aw, n) + _cross3(av, F), _cross3(aw, F)], dim=-1)


def _rot_axis(axis: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a unit ``axis`` (...,3) by ``q`` (...);
    returns E = R(q)^T (parent coords -> child coords)."""
    K = _hat(axis)
    s, c = torch.sin(q)[..., None, None], torch.cos(q)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    R = eye + s * K + (1.0 - c) * (K @ K)
    return _mT(R)


# ---------------------------------------------------------------------------
# Per-leg kinematic sweep (shared by CRBA and RNEA)
# ---------------------------------------------------------------------------

def _leg_transforms(model: RbdModel, q_legs: torch.Tensor):
    """Per-link (E (...,4,3,3,3), t (...,4,3,3), X (...,4,3,6,6)) of the four
    legs' chains at joint angles ``q_legs`` (...,4,3)."""
    E = _rot_axis(model.joint_axis, q_legs)
    t = model.joint_origin
    return E, t, _xmat(E, t)


def _leg_spatial_inertias(model: RbdModel) -> torch.Tensor:
    """(...,4,3,6,6) link spatial inertias."""
    return _spatial_inertia(model.link_mass, model.link_com, model.link_inertia)


def _motion_subspace(model: RbdModel) -> torch.Tensor:
    """(...,4,3,6) hinge motion subspaces [axis, 0]."""
    return torch.cat([model.joint_axis, torch.zeros_like(model.joint_axis)], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


# ---------------------------------------------------------------------------
# CRBA: 18x18 mass matrix
# ---------------------------------------------------------------------------

def mass_matrix(model: RbdModel, q: torch.Tensor) -> torch.Tensor:
    """Composite-rigid-body mass matrix H (...,18,18) in the internal u order
    [omega_b, v_b, qd] at joint angles ``q`` (...,12).  Armature adds to the
    12 hinge diagonals."""
    lead = q.shape[:-1]
    _, _, X = _leg_transforms(model, q.reshape(lead + (4, 3)))
    XT = _mT(X)
    I_links = _leg_spatial_inertias(model)
    S = _motion_subspace(model)
    X0, X1, X2 = X.unbind(-3)
    XT0, XT1, XT2 = XT.unbind(-3)

    # Composite inertias up the chain (calf -> thigh -> hip).
    Ic2 = I_links[..., 2, :, :]
    Ic1 = I_links[..., 1, :, :] + XT2 @ Ic2 @ X2
    Ic0 = I_links[..., 0, :, :] + XT1 @ Ic1 @ X1
    Ic = torch.stack([Ic0, Ic1, Ic2], dim=-3)

    # F_j = Ic_j S_j in j's frame, carried to every ancestor with X^T.
    F = _mv(Ic, S)                                            # (...,4,3,6)
    S0, S1, S2 = S.unbind(-2)
    F0, F1, F2 = F.unbind(-2)
    F2_at1 = _mv(XT2, F2)
    F2_at0 = _mv(XT1, F2_at1)
    F1_at0 = _mv(XT1, F1)

    h00, h11, h22 = _dot(S0, F0), _dot(S1, F1), _dot(S2, F2)
    h12, h01, h02 = _dot(S1, F2_at1), _dot(S0, F1_at0), _dot(S0, F2_at0)
    Hl = torch.stack([
        torch.stack([h00, h01, h02], dim=-1),
        torch.stack([h01, h11, h12], dim=-1),
        torch.stack([h02, h12, h22], dim=-1),
    ], dim=-2) + torch.diag_embed(model.armature)              # (...,4,3,3)

    # Base coupling (each F_j in the base frame) and the legs' composite
    # inertias at the base.
    F_base = torch.stack([_mv(XT0, F0), _mv(XT0, F1_at0), _mv(XT0, F2_at0)], dim=-2)
    Ic_base = XT0 @ Ic0 @ X0                                   # (...,4,6,6)

    I_trunk = _spatial_inertia(model.trunk_mass, model.trunk_com, model.trunk_inertia)
    H_bb = I_trunk + Ic_base.sum(dim=-3)
    F_rows = F_base.reshape(lead + (12, 6))
    eye4 = torch.eye(4, dtype=q.dtype, device=q.device)
    H_legs = (Hl[..., :, :, None, :] * eye4[:, None, :, None]).reshape(lead + (12, 12))
    return torch.cat([
        torch.cat([H_bb, _mT(F_rows)], dim=-1),
        torch.cat([F_rows, H_legs], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# RNEA: bias forces (gravity + velocity products + external foot forces)
# ---------------------------------------------------------------------------

def bias_forces(
    model: RbdModel,
    q: torch.Tensor,
    u: torch.Tensor,
    R_base: torch.Tensor,
    f_feet_world: torch.Tensor,
) -> torch.Tensor:
    """C(q, u) - tau_ext (...,18): generalized forces such that
    H du = tau - C.

    ``R_base`` (...,3,3) is the base orientation (world <- body); gravity
    enters as the fictitious upward base acceleration.  ``f_feet_world``
    (...,4,3) are external world-frame forces at the foot points.  Joint
    damping is not included (:func:`forward_dynamics` adds it)."""
    lead = q.shape[:-1]
    q_legs = q.reshape(lead + (4, 3))
    qd_legs = u[..., 6:].reshape(lead + (4, 3))
    v0 = u[..., :6]
    # R_base^T e_z * g, in base coordinates.
    g_up = R_base[..., 2, :] * model.gravity[..., None]
    a0 = torch.cat([torch.zeros_like(g_up), g_up], dim=-1)

    E, _, X = _leg_transforms(model, q_legs)
    XT = _mT(X)
    I_links = _leg_spatial_inertias(model)
    S = _motion_subspace(model)

    vp = v0[..., None, :].expand(lead + (4, 6))
    ap = a0[..., None, :].expand(lead + (4, 6))
    Rlink = None                                              # base <- link
    fs = []
    for j in range(3):
        Sq = S[..., j, :] * qd_legs[..., j, None]
        vj = _mv(X[..., j, :, :], vp) + Sq
        aj = _mv(X[..., j, :, :], ap) + _cross_motion(vj, Sq)
        Ej_T = _mT(E[..., j, :, :])
        Rlink = Ej_T if Rlink is None else Rlink @ Ej_T
        Ij = I_links[..., j, :, :]
        fs.append(_mv(Ij, aj) + _cross_force(vj, _mv(Ij, vj)))
        vp, ap = vj, aj

    # Foot force (world) -> spatial force in calf coordinates.
    f_lin = _mv(_mT(R_base[..., None, :, :] @ Rlink), f_feet_world)
    n = _cross3(model.foot_offset, f_lin)
    fs[2] = fs[2] - torch.cat([n, f_lin], dim=-1)

    # Backward pass.
    fcur = fs[2]
    tau2 = _dot(S[..., 2, :], fcur)
    fcur = fs[1] + _mv(XT[..., 2, :, :], fcur)
    tau1 = _dot(S[..., 1, :], fcur)
    fcur = fs[0] + _mv(XT[..., 1, :, :], fcur)
    tau0 = _dot(S[..., 0, :], fcur)
    f_to_base = _mv(XT[..., 0, :, :], fcur)                   # (...,4,6)
    tau_legs = torch.stack([tau0, tau1, tau2], dim=-1)        # (...,4,3)

    I_trunk = _spatial_inertia(model.trunk_mass, model.trunk_com, model.trunk_inertia)
    f_base = (_mv(I_trunk, a0) + _cross_force(v0, _mv(I_trunk, v0))
              + f_to_base.sum(dim=-2))
    return torch.cat([f_base, tau_legs.reshape(lead + (12,))], dim=-1)


# ---------------------------------------------------------------------------
# Forward dynamics + convention conversions
# ---------------------------------------------------------------------------

def spd_solve(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``H^-1 rhs`` for SPD ``H`` (...,n,n) and ``rhs`` (...,n), in float32;
    NaN for a scenario whose factorization failed."""
    L, info = torch.linalg.cholesky_ex(H)
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    x = torch.linalg.solve_triangular(_mT(L), y, upper=True)[..., 0]
    return torch.where((info != 0)[..., None], torch.full_like(x, float("nan")), x)


def forward_dynamics(
    model: RbdModel,
    q: torch.Tensor,
    u: torch.Tensor,
    R_base: torch.Tensor,
    tau: torch.Tensor,
    f_feet_world: torch.Tensor,
) -> torch.Tensor:
    """du (...,18) = H^-1 (tau_gen - C - d*qd).

    ``tau`` (...,12) are the hinge motor torques; the base rows carry no
    actuation.  Joint damping is an explicit passive force -d*qd on the
    right-hand side, MuJoCo's continuous passive-force model.  Spans
    ``rbd.rnea`` (the bias forces) and ``rbd.crba`` (the mass matrix)."""
    with profiling.span("rbd.rnea"):
        C = bias_forces(model, q, u, R_base, f_feet_world)
    lead = q.shape[:-1]
    qd = u[..., 6:]
    damp = model.damping.reshape(lead + (12,)) * qd
    zeros6 = torch.zeros(lead + (6,), dtype=q.dtype, device=q.device)
    rhs = torch.cat([zeros6, tau], dim=-1) - C - torch.cat([zeros6, damp], dim=-1)
    with profiling.span("rbd.crba"):
        H = mass_matrix(model, q)
    return spd_solve(H, rhs)


def u_from_mujoco(qvel: torch.Tensor, R_base: torch.Tensor) -> torch.Tensor:
    """MuJoCo free-joint qvel [v_world, omega_body, qd] -> internal
    [omega_body, v_body, qd]."""
    v_world, w_body, qd = qvel[..., :3], qvel[..., 3:6], qvel[..., 6:]
    return torch.cat([w_body, _mv(_mT(R_base), v_world), qd], dim=-1)


def qacc_to_mujoco(du: torch.Tensor, u: torch.Tensor, R_base: torch.Tensor) -> torch.Tensor:
    """Internal du -> MuJoCo qacc [a_world, alpha_body, qdd]:
    a_world = R (dv_b + omega_b x v_b)."""
    dw, dv, qdd = du[..., :3], du[..., 3:6], du[..., 6:]
    w, v = u[..., :3], u[..., 3:6]
    return torch.cat([_mv(R_base, dv + _cross3(w, v)), dw, qdd], dim=-1)
