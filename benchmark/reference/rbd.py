"""Plain rigid-body dynamics of the floating quadruped tree.

Featherstone's spatial algebra, (angular, linear) ordering, body
coordinates: the composite-rigid-body algorithm for the 18x18 mass matrix,
the recursive Newton-Euler algorithm for the bias forces with gravity as an
upward base acceleration and world-frame forces at the feet, and a dense
solve for the accelerations.  Generalised velocity u = [omega_b, v_b, qd]
(base angular and linear velocity in the body frame, 12 hinge rates).
Every product runs in ``prec`` (:mod:`.precision`).
"""
from __future__ import annotations

import torch


def _hat(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _T(a):
    return a.transpose(-1, -2)


def _xmat(prec, E, t):
    """Motion transform parent -> child of a child frame at ``t`` (parent
    coordinates) rotated by ``E`` (parent to child coordinates)."""
    Z = torch.zeros_like(E)
    return torch.cat([torch.cat([E, Z], -1), torch.cat([-prec.mm(E, _hat(t)), E], -1)], -2)


def _inertia(prec, mass, com, I_com):
    """6x6 spatial inertia about the body origin."""
    c = _hat(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    top = torch.cat([I_com - m * prec.mm(c, c), m * c], -1)
    return torch.cat([top, torch.cat([-(m * c), m * eye], -1)], -2)


def _cross_m(a, b):
    return torch.cat([torch.linalg.cross(a[..., :3], b[..., :3], dim=-1),
                      torch.linalg.cross(a[..., :3], b[..., 3:], dim=-1)
                      + torch.linalg.cross(a[..., 3:], b[..., :3], dim=-1)], -1)


def _cross_f(a, f):
    return torch.cat([torch.linalg.cross(a[..., :3], f[..., :3], dim=-1)
                      + torch.linalg.cross(a[..., 3:], f[..., 3:], dim=-1),
                      torch.linalg.cross(a[..., :3], f[..., 3:], dim=-1)], -1)


def _chains(prec, model, q_legs):
    """Per link: E (parent to child), X (motion transform), spatial inertia
    and motion subspace, shapes (R,4,3,...)."""
    axis = model["joint_axis"]
    K = _hat(axis)
    s, c = torch.sin(q_legs)[..., None, None], torch.cos(q_legs)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    E = _T(eye + s * K + (1.0 - c) * prec.mm(K, K))
    X = _xmat(prec, E, model["joint_origin"])
    I = _inertia(prec, model["link_mass"], model["link_com"], model["link_inertia"])
    S = torch.cat([axis, torch.zeros_like(axis)], -1)
    return E, X, I, S


def mass_matrix(prec, model, q):
    R_ = q.shape[0]
    _, X, I, S = _chains(prec, model, q.reshape(R_, 4, 3))
    XT = _T(X)
    mv = prec.mv
    Ic2 = I[:, :, 2]
    Ic1 = I[:, :, 1] + prec.mm(prec.mm(XT[:, :, 2], Ic2), X[:, :, 2])
    Ic0 = I[:, :, 0] + prec.mm(prec.mm(XT[:, :, 1], Ic1), X[:, :, 1])
    F0, F1, F2 = mv(Ic0, S[:, :, 0]), mv(Ic1, S[:, :, 1]), mv(Ic2, S[:, :, 2])
    F2_1 = mv(XT[:, :, 2], F2)
    F2_0 = mv(XT[:, :, 1], F2_1)
    F1_0 = mv(XT[:, :, 1], F1)
    d = lambda a, b: (a * b).sum(-1)
    h00, h11, h22 = d(S[:, :, 0], F0), d(S[:, :, 1], F1), d(S[:, :, 2], F2)
    h12, h01, h02 = d(S[:, :, 1], F2_1), d(S[:, :, 0], F1_0), d(S[:, :, 0], F2_0)
    Hl = torch.stack([torch.stack([h00, h01, h02], -1), torch.stack([h01, h11, h12], -1),
                      torch.stack([h02, h12, h22], -1)], -2) + torch.diag_embed(model["armature"])
    XT0 = XT[:, :, 0]
    F_base = torch.stack([mv(XT0, F0), mv(XT0, F1_0), mv(XT0, F2_0)], -2).reshape(R_, 12, 6)
    I_trunk = _inertia(prec, model["trunk_mass"], model["trunk_com"], model["trunk_inertia"])
    H_bb = I_trunk + prec.mm(prec.mm(XT0, Ic0), X[:, :, 0]).sum(1)
    H = q.new_zeros(R_, 18, 18)
    H[:, :6, :6] = H_bb
    H[:, :6, 6:] = _T(F_base)
    H[:, 6:, :6] = F_base
    for leg in range(4):
        H[:, 6 + 3 * leg:9 + 3 * leg, 6 + 3 * leg:9 + 3 * leg] = Hl[:, leg]
    return H


def bias_forces(prec, model, q, u, R_base, f_feet):
    """C(q, u) - tau_ext: gravity, velocity products and the foot forces."""
    R_ = q.shape[0]
    qd = u[:, 6:].reshape(R_, 4, 3)
    v0 = u[:, :6]
    g_up = R_base[:, 2, :] * model["gravity"][:, None]
    a0 = torch.cat([torch.zeros_like(g_up), g_up], -1)
    E, X, I, S = _chains(prec, model, q.reshape(R_, 4, 3))
    XT = _T(X)
    mv = prec.mv
    vp = v0[:, None, :].expand(R_, 4, 6)
    ap = a0[:, None, :].expand(R_, 4, 6)
    R_link = None
    fs = []
    for j in range(3):
        Sq = S[:, :, j] * qd[:, :, j, None]
        vj = mv(X[:, :, j], vp) + Sq
        aj = mv(X[:, :, j], ap) + _cross_m(vj, Sq)
        EjT = _T(E[:, :, j])
        R_link = EjT if R_link is None else prec.mm(R_link, EjT)
        Ij = I[:, :, j]
        fs.append(mv(Ij, aj) + _cross_f(vj, mv(Ij, vj)))
        vp, ap = vj, aj
    f_lin = mv(_T(prec.mm(R_base[:, None], R_link)), f_feet)
    fs[2] = fs[2] - torch.cat([torch.linalg.cross(model["foot_offset"], f_lin, dim=-1), f_lin], -1)
    f = fs[2]
    tau2 = (S[:, :, 2] * f).sum(-1)
    f = fs[1] + mv(XT[:, :, 2], f)
    tau1 = (S[:, :, 1] * f).sum(-1)
    f = fs[0] + mv(XT[:, :, 1], f)
    tau0 = (S[:, :, 0] * f).sum(-1)
    to_base = mv(XT[:, :, 0], f).sum(1)
    I_trunk = _inertia(prec, model["trunk_mass"], model["trunk_com"], model["trunk_inertia"])
    f_base = mv(I_trunk, a0) + _cross_f(v0, mv(I_trunk, v0)) + to_base
    return torch.cat([f_base, torch.stack([tau0, tau1, tau2], -1).reshape(R_, 12)], -1)


def forward_dynamics(prec, model, q, u, R_base, tau, f_feet):
    """du = H^-1 (tau - C - damping * qd); NaN where H is not positive
    definite."""
    C = bias_forces(prec, model, q, u, R_base, f_feet)
    zeros6 = torch.zeros_like(u[:, :6])
    rhs = torch.cat([zeros6, tau - model["damping"].reshape(-1, 12) * u[:, 6:]], -1) - C
    L, info = torch.linalg.cholesky_ex(mass_matrix(prec, model, q))
    du = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    return torch.where((info != 0)[:, None], torch.full_like(du, float("nan")), du)


def model_from_spec(robot, spec, dtype, device):
    """The tree's parameters from the robot's leg geometry and the link
    inertials of ``spec`` (the configuration's ``links``): right legs'
    link centres of mass mirrored in y."""
    R_ = robot["mass"].shape[0]
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    mirror = torch.sign(robot["hip_len"])                              # (R,4)

    def link(entry):
        com = t(entry["com"]).expand(R_, 4, 3)
        com = torch.stack([com[..., 0], mirror * com[..., 1], com[..., 2]], -1)
        return (t(entry["mass"]).expand(R_, 4), com,
                torch.diag(t(entry["diag"])).expand(R_, 4, 3, 3))

    (hm, hc, hi), (tm, tc, ti), (cm, cc, ci) = (link(spec[k]) for k in ("hip", "thigh", "calf"))
    zeros = torch.zeros(R_, 4, dtype=dtype, device=device)
    l_thigh = robot["l_thigh"][:, None].expand(R_, 4)
    l_calf = robot["l_calf"][:, None].expand(R_, 4)
    eye = torch.eye(3, dtype=dtype, device=device)
    trunk = spec["trunk"]
    return dict(
        trunk_mass=t(trunk["mass"]).expand(R_), trunk_com=t(trunk["com"]).expand(R_, 3),
        trunk_inertia=torch.diag(t(trunk["diag"])).expand(R_, 3, 3),
        link_mass=torch.stack([hm, tm, cm], -1), link_com=torch.stack([hc, tc, cc], -2),
        link_inertia=torch.stack([hi, ti, ci], -3),
        joint_origin=torch.stack([robot["hip_offset"],
                                  torch.stack([zeros, robot["hip_len"], zeros], -1),
                                  torch.stack([zeros, zeros, -l_thigh], -1)], -2),
        joint_axis=torch.stack([eye[0], eye[1], eye[1]]).expand(R_, 4, 3, 3),
        foot_offset=torch.stack([zeros, zeros, -l_calf], -1),
        armature=torch.full((R_, 4, 3), spec["joint_armature"], dtype=dtype, device=device),
        damping=torch.full((R_, 4, 3), spec["joint_damping"], dtype=dtype, device=device),
        gravity=torch.full((R_,), spec["gravity"], dtype=dtype, device=device),
    )
