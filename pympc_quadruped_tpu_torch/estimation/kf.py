"""Two-stage state estimator (port of ``estimation/kf.py``).

Stage 1, orientation: a complementary filter on the gyro with an
accelerometer tilt correction, ``q <- q * exp((omega + kappa e_tilt) dt/2)``
with ``kappa = k_cf * clip(1 - |(|a| - g)| / g, 0, 1)``.

Stage 2, translation: an 18-state linear KF, ``x = [p, v, 4 feet]``, with
``p' = p + v dt + a dt^2/2``, ``v' = v + a dt`` (``a = R a_meas - g e_z``),
feet constant; 28 measurements: per-leg relative foot position from FK
(12), per-leg leg-odometry velocity (12) and stance-foot height (4), the
swing legs' rows boosted in variance so shapes stay static.

Every function takes a leading scenario axis on the state, the sensors and
the robot; :class:`KfParams` (0-d tensors) is shared by the batch, as in
the JAX rollout.  The measurement matrix is a constant, built once per
device.  The 28x28 innovation solve (:func:`spd_solve`) is a Cholesky
factorization and two triangular solves: ``torch.linalg.solve_ex`` and
``cholesky_solve`` break the capture of the rollout tick in a CUDA graph on
the card (tools/graph_capture_probe.py), and these capture.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import kin, lie

NUM_X = 18  # [p, v, 4 foot positions]
NUM_Z = 28  # [12 relative foot positions, 12 leg velocities, 4 foot heights]


@dataclass
class KfParams:
    dt: torch.Tensor
    gravity: torch.Tensor
    k_cf: torch.Tensor                 # complementary-filter gain
    sigma_proc_pos: torch.Tensor
    sigma_proc_vel: torch.Tensor
    sigma_proc_foot_stance: torch.Tensor
    sigma_proc_foot_swing: torch.Tensor
    sigma_meas_fk: torch.Tensor        # relative foot position measurement
    sigma_meas_vel: torch.Tensor       # leg-odometry velocity measurement
    sigma_meas_height: torch.Tensor    # stance foot height pseudo-measurement
    swing_noise_boost: torch.Tensor    # multiplier applied to swing-foot rows
    contact_height: torch.Tensor       # assumed stance-foot height (0 for point feet)

    @staticmethod
    def default(dt: float = 0.001, device="cuda") -> "KfParams":
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return KfParams(
            dt=f(dt),
            gravity=f(9.81),
            k_cf=f(0.1),
            sigma_proc_pos=f(0.02),
            sigma_proc_vel=f(0.2),
            sigma_proc_foot_stance=f(0.002),
            sigma_proc_foot_swing=f(10.0),
            sigma_meas_fk=f(0.002),
            sigma_meas_vel=f(0.05),
            sigma_meas_height=f(0.005),
            swing_noise_boost=f(1.0e4),
            contact_height=f(0.0),
        )


@dataclass
class KfState:
    quat: torch.Tensor   # (...,4) estimated orientation, wxyz
    x: torch.Tensor      # (...,18) [p, v, foot positions]
    P: torch.Tensor      # (...,18,18) covariance

    @staticmethod
    def init(pos0: torch.Tensor, feet0: torch.Tensor) -> "KfState":
        """From base positions (...,3) and feet (...,4,3)."""
        lead = pos0.shape[:-1]
        f32 = dict(dtype=torch.float32, device=pos0.device)
        x = torch.cat([pos0, torch.zeros(lead + (3,), **f32),
                       feet0.reshape(lead + (12,))], dim=-1)
        quat = torch.zeros(lead + (4,), **f32)
        quat[..., 0] = 1.0
        P = (torch.eye(NUM_X, **f32) * 0.1).expand(lead + (NUM_X, NUM_X)).clone()
        return KfState(quat=quat, x=x, P=P)


def _measurement_matrix_np() -> np.ndarray:
    Hm = np.zeros((NUM_Z, NUM_X), np.float32)
    for leg in range(4):
        r0 = 3 * leg
        Hm[r0:r0 + 3, 6 + 3 * leg:9 + 3 * leg] = np.eye(3)
        Hm[r0:r0 + 3, 0:3] = -np.eye(3)
        Hm[12 + r0:15 + r0, 3:6] = np.eye(3)
        Hm[24 + leg, 8 + 3 * leg] = 1.0
    return Hm


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(Hm, I, E) on ``device``: the measurement matrix, the 18x18 identity
    and the velocity block of the process matrix (F = I + dt E).  Built on
    the first update on a device, which a rollout makes before it captures
    its tick."""
    E = np.zeros((NUM_X, NUM_X), np.float32)
    E[0:3, 3:6] = np.eye(3)
    to = lambda a: torch.from_numpy(a).to(device)
    return to(_measurement_matrix_np()), to(np.eye(NUM_X, dtype=np.float32)), to(E)


def spd_solve(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``S^-1 rhs`` for symmetric positive definite ``S`` (...,n,n) and
    ``rhs`` (...,n,k): ``cholesky_ex`` and two ``solve_triangular``, which
    report no error on the host, so a captured tick can run them.  In
    float64: in float32 the Cholesky route loses about a digit of the
    estimate against the pivoted LU of JAX's ``jnp.linalg.solve``."""
    L = torch.linalg.cholesky_ex(S.double())[0]
    y = torch.linalg.solve_triangular(L, rhs.double(), upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True).to(rhs.dtype)


def _matvec(A, v):
    return (A @ v[..., None])[..., 0]


def _repeat3(v):
    """Each entry of (...,4) three times (jnp.repeat(v, 3)) -> (...,12)."""
    return v[..., None].expand(v.shape + (3,)).reshape(v.shape[:-1] + (12,))


def orientation_update(state: KfState, gyro: torch.Tensor, accel: torch.Tensor,
                       params: KfParams) -> torch.Tensor:
    """Complementary filter tick -> new quaternion (...,4)."""
    R = lie.quat_to_rotmat(state.quat)
    g_body = R[..., 2, :]                         # R^T e_z
    a_mag = torch.linalg.vector_norm(accel, dim=-1, keepdim=True)
    a_norm = accel / torch.clamp(a_mag, min=1e-6)
    e_tilt = torch.linalg.cross(a_norm, g_body, dim=-1)
    g = params.gravity
    kappa = params.k_cf * torch.clamp(1.0 - torch.abs(a_mag - g) / g, 0.0, 1.0)
    omega_corr = gyro + kappa * e_tilt
    return lie.quat_integrate(state.quat, omega_corr, params.dt)


def _process(params: KfParams, quat, accel, x):
    """A x + B u for the 18-state translation model."""
    dt = params.dt
    R = lie.quat_to_rotmat(quat)
    acc_world = _matvec(R, accel)
    acc_world = torch.cat([acc_world[..., :2], acc_world[..., 2:] - params.gravity], dim=-1)
    p, v, feet = x[..., 0:3], x[..., 3:6], x[..., 6:]
    p_new = p + dt * v + 0.5 * dt * dt * acc_world
    v_new = v + dt * acc_world
    return torch.cat([p_new, v_new, feet], dim=-1)


def update(
    state: KfState,
    robot: RobotParams,
    gyro: torch.Tensor,
    accel: torch.Tensor,
    q_joints: torch.Tensor,
    qd_joints: torch.Tensor,
    contact: torch.Tensor,  # (...,4) stance flags
    params: KfParams,
) -> KfState:
    """One predict+correct tick, batched over the leading axes."""
    Hm, eye, E = _constants(state.x.device)
    lead = state.x.shape[:-1]
    quat = orientation_update(state, gyro, accel, params)
    R = lie.quat_to_rotmat(quat)
    dt = params.dt

    # ---- predict -----------------------------------------------------
    F = eye + dt * E
    x_pred = _process(params, quat, accel, state.x)
    foot_sig = torch.where(contact > 0.0, params.sigma_proc_foot_stance,
                           params.sigma_proc_foot_swing)
    ones = torch.ones(lead + (12,), dtype=torch.float32, device=state.x.device)
    q_diag = torch.cat([ones[..., :3] * params.sigma_proc_pos ** 2,
                        ones[..., :3] * params.sigma_proc_vel ** 2,
                        _repeat3(foot_sig ** 2)], dim=-1)
    P_pred = F @ state.P @ F.transpose(-1, -2) + torch.diag_embed(q_diag) * dt

    # ---- measurements ------------------------------------------------
    q_legs = q_joints.reshape(lead + (4, 3))
    qd_legs = qd_joints.reshape(lead + (4, 3))
    p_bf, J = kin.leg_forward_kinematics(robot, q_legs)
    RT = R.transpose(-1, -2)
    rel_pos_world = p_bf @ RT
    rel_vel_world = (
        torch.linalg.cross(gyro[..., None, :].expand_as(p_bf), p_bf, dim=-1)
        + _matvec(J, qd_legs)
    ) @ RT
    z = torch.cat([rel_pos_world.reshape(lead + (12,)),
                   -rel_vel_world.reshape(lead + (12,)),
                   ones[..., :4] * params.contact_height], dim=-1)

    leg_boost = torch.where(contact > 0.0, torch.ones_like(contact),
                            params.swing_noise_boost * torch.ones_like(contact))
    r_diag = torch.cat([
        ones * params.sigma_meas_fk ** 2,
        _repeat3(params.sigma_meas_vel ** 2 * leg_boost),
        params.sigma_meas_height ** 2 * leg_boost,
    ], dim=-1)

    # ---- correct -----------------------------------------------------
    y = z - _matvec(Hm, x_pred)
    HP = Hm @ P_pred
    S = HP @ Hm.T + torch.diag_embed(r_diag)
    K = spd_solve(S, HP).transpose(-1, -2)
    x_new = x_pred + _matvec(K, y)
    P_new = (eye - K @ Hm) @ P_pred
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
    return KfState(quat=quat, x=x_new, P=P_new)


def to_obs(state: KfState, gyro, q_joints, qd_joints) -> kin.RobotObs:
    """Package the estimate as the controller's observation interface."""
    return kin.RobotObs(
        pos_base=state.x[..., 0:3],
        lin_vel_base=state.x[..., 3:6],
        quat_base=state.quat,
        ang_vel_base=gyro,
        q=q_joints,
        qdot=qd_joints,
    )
