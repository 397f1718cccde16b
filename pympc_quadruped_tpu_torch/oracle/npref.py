"""Float64 golden model of the reference controller, in PyTorch (port of
``oracle/npref.py``).

The exact control law of ``yinghansun/pympc-quadruped`` written from the
JAX package's numpy oracle function by function, with its quirks:
dt_predict = 0.05 against dt_gait = 0.02, the +-0.1 m desired-position clamp
written back, the -0.0255 m touchdown height, the Pinocchio world/body
velocity-frame mix-up in relative foot velocities, and the strict ``>``
swing-window comparisons.

It shares no code with the port's compute path: it imports ``torch`` and
``numpy`` only, nothing of ``ops/``, ``control/``, ``env/`` or
``models/``, so it can judge them on the card, where the JAX package is
not installed.

The QP oracle :func:`solve_qp_kkt` is a float64 predictor-corrector
interior-point solve iterated to KKT residuals ~1e-10, and returns those
residuals as its certificate.  It and :meth:`OracleController._condensed_qp`
also take a leading batch dimension.

Devices: functions that take raw data (numpy or tensors) take ``device``,
default ``"cuda"``; functions and methods of the oracle's own objects
(``OracleRobot``, ``OracleGait``, ``OracleConfig``) work on the device
those were built on.  The controller's branches (the 50 Hz solve gate,
the integrator gates, each leg's swing state) are host decisions on
values brought to the host once a tick; its carry's scalars are host
floats, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

F64 = torch.float64


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=device)


# ---------------------------------------------------------------- rotations


def quat_to_rotmat(q, device="cuda"):
    w, x, y, z = _f64(q, device).unbind(-1)
    rows = [
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z)],
        [2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_to_zyx(q, device="cuda"):
    w, x, y, z = _f64(q, device).unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], -1)


def rot_z(t, device="cuda"):
    t = _f64(t, device)
    c, s = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    return torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def skew(v, device="cuda"):
    v0, v1, v2 = _f64(v, device).unbind(-1)
    zero = torch.zeros_like(v0)
    return torch.stack([torch.stack([zero, -v2, v1], -1), torch.stack([v2, zero, -v0], -1),
                        torch.stack([-v1, v0, zero], -1)], -2)


# ---------------------------------------------------------------- parameters


@dataclass
class OracleRobot:
    mass: float
    inertia: torch.Tensor
    base_height_des: float
    fz_max: float
    swing_height: float
    kp_swing: torch.Tensor
    kd_swing: torch.Tensor
    hip_offset: torch.Tensor  # (4,3)
    hip_len: torch.Tensor     # (4,) signed
    l_thigh: float
    l_calf: float
    touchdown_z: float = -0.0255

    @property
    def device(self) -> torch.device:
        return self.inertia.device


def oracle_aliengo(device="cuda") -> OracleRobot:
    inertia = [
        [0.033260231, -0.000451628, 0.000487603],
        [-0.000451628, 0.16117211, 4.8356e-05],
        [0.000487603, 4.8356e-05, 0.17460442],
    ]
    hips = [
        [0.2399, 0.051, 0.0],
        [0.2399, -0.051, 0.0],
        [-0.2399, 0.051, 0.0],
        [-0.2399, -0.051, 0.0],
    ]
    return OracleRobot(
        mass=9.042,
        inertia=_f64(inertia, device),
        base_height_des=0.38,
        fz_max=500.0,
        swing_height=0.1,
        kp_swing=torch.full((3,), 200.0, dtype=F64, device=device),
        kd_swing=torch.full((3,), 20.0, dtype=F64, device=device),
        hip_offset=_f64(hips, device),
        hip_len=_f64([0.083, -0.083, 0.083, -0.083], device),
        l_thigh=0.25,
        l_calf=0.25,
    )


def oracle_a1(device="cuda") -> OracleRobot:
    inertia = np.array(
        [
            [0.01683993, 8.3902e-05, 0.000597679],
            [8.3902e-05, 0.056579028, 2.5134e-05],
            [0.000597679, 2.5134e-05, 0.064713601],
        ]
    ) * 10.0
    hips = [
        [0.183, 0.047, 0.0],
        [0.183, -0.047, 0.0],
        [-0.183, 0.047, 0.0],
        [-0.183, -0.047, 0.0],
    ]
    return OracleRobot(
        mass=4.713,
        inertia=_f64(inertia, device),
        base_height_des=0.42,
        fz_max=500.0,
        swing_height=0.1,
        kp_swing=torch.full((3,), 700.0, dtype=F64, device=device),
        kd_swing=torch.full((3,), 20.0, dtype=F64, device=device),
        hip_offset=_f64(hips, device),
        hip_len=_f64([0.08505, -0.08505, 0.08505, -0.08505], device),
        l_thigh=0.2,
        l_calf=0.2,
    )


_Q_DIAG = [5.0, 5.0, 10.0, 10.0, 10.0, 50.0, 0.01, 0.01, 0.2, 0.2, 0.2, 0.2, 0.0]


@dataclass
class OracleConfig:
    dt_control: float = 0.001
    iterations_between_mpc: int = 20
    dt_predict: float = 0.05
    horizon: int = 16
    gravity: float = 9.81
    mu: float = 0.7
    q_diag: torch.Tensor = None   # default: the reference's diag(Q), on ``device``
    r_scalar: float = 1.0e-5
    device: str | torch.device = field(default="cuda", repr=False)

    def __post_init__(self):
        self.q_diag = _f64(_Q_DIAG if self.q_diag is None else self.q_diag, self.device)

    @property
    def dt_gait(self):
        return self.dt_control * self.iterations_between_mpc


@dataclass
class OracleGait:
    num_segments: int
    stance_offsets: torch.Tensor
    stance_durations: torch.Tensor

    @staticmethod
    def _make(num_segments, offsets, durations, device):
        as_int = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
        return OracleGait(num_segments, as_int(offsets), as_int(durations))

    @staticmethod
    def trotting10(device="cuda"):
        return OracleGait._make(10, [0, 5, 5, 0], [5, 5, 5, 5], device)

    @staticmethod
    def standing(device="cuda"):
        return OracleGait._make(16, [0] * 4, [16] * 4, device)

    @staticmethod
    def trotting16(device="cuda"):
        return OracleGait._make(16, [0, 8, 8, 0], [8, 8, 8, 8], device)

    @staticmethod
    def pacing10(device="cuda"):
        return OracleGait._make(10, [5, 0, 5, 0], [5, 5, 5, 5], device)

    @staticmethod
    def pacing16(device="cuda"):
        return OracleGait._make(16, [8, 0, 8, 0], [8, 8, 8, 8], device)

    @staticmethod
    def jumping16(device="cuda"):
        return OracleGait._make(16, [0] * 4, [4] * 4, device)

    @staticmethod
    def bounding8(device="cuda"):
        return OracleGait._make(8, [4, 4, 0, 0], [4, 4, 4, 4], device)

    @staticmethod
    def by_name(name: str, device="cuda") -> "OracleGait":
        """Same library as the JAX side (ref linear_mpc/gait.py:16-22)."""
        return {
            "standing": OracleGait.standing,
            "trotting10": OracleGait.trotting10,
            "trotting16": OracleGait.trotting16,
            "pacing10": OracleGait.pacing10,
            "pacing16": OracleGait.pacing16,
            "jumping16": OracleGait.jumping16,
            "bounding8": OracleGait.bounding8,
        }[name](device)


# ---------------------------------------------------------------- kinematics


def leg_fk(robot: OracleRobot, q_legs):
    """(4,3) joint angles -> (4,3) base-frame foot positions, (4,3,3) Jacobians."""
    q_legs = _f64(q_legs, robot.device)
    q1, q2, q3 = q_legs[..., 0], q_legs[..., 1], q_legs[..., 2]
    s_hip, l2, l3 = robot.hip_len, robot.l_thigh, robot.l_calf
    c1, s1 = torch.cos(q1), torch.sin(q1)
    c2, s2 = torch.cos(q2), torch.sin(q2)
    c23, s23 = torch.cos(q2 + q3), torch.sin(q2 + q3)
    u = -l2 * s2 - l3 * s23
    w = -l2 * c2 - l3 * c23
    p = robot.hip_offset + torch.stack([u, c1 * s_hip - s1 * w, s1 * s_hip + c1 * w], -1)
    zero = torch.zeros_like(q1)
    col1 = torch.stack([zero, -s1 * s_hip - c1 * w, c1 * s_hip - s1 * w], -1)
    col2 = torch.stack([w, s1 * u, -c1 * u], -1)
    col3 = torch.stack([-l3 * c23, -s1 * l3 * s23, c1 * l3 * s23], -1)
    J = torch.stack([col1, col2, col3], -1)
    return p, J


def thigh_pos(robot: OracleRobot, q_legs):
    q1 = _f64(q_legs, robot.device)[..., 0]
    return robot.hip_offset + torch.stack(
        [torch.zeros_like(q1), torch.cos(q1) * robot.hip_len, torch.sin(q1) * robot.hip_len], -1
    )


@dataclass
class OracleKin:
    R: torch.Tensor
    rpy: torch.Tensor
    pos_base: torch.Tensor
    vel_base: torch.Tensor
    omega_body: torch.Tensor
    p_bf: torch.Tensor           # (4,3) base frame
    pos_feet: torch.Tensor       # (4,3) world
    pos_base_feet: torch.Tensor
    vel_rel_base: torch.Tensor
    thighs: torch.Tensor
    J: torch.Tensor              # (4,3,3)


_OBS_KEYS = ("quat", "pos", "vel", "omega", "q", "qdot")


def _obs_tensors(obs: dict, device) -> list:
    """The observation's arrays as float64 tensors on ``device``: host
    arrays in one copy, tensors moved as they are."""
    if any(isinstance(obs[k], torch.Tensor) for k in _OBS_KEYS):
        return [_f64(obs[k], device).reshape(-1) for k in _OBS_KEYS]
    parts = [np.asarray(obs[k], np.float64).reshape(-1) for k in _OBS_KEYS]
    flat = _f64(np.concatenate(parts), device)
    return list(torch.split(flat, [p.size for p in parts]))


def kin_update(robot: OracleRobot, obs: dict, vel_quirk: bool = True) -> OracleKin:
    dev = robot.device
    quat, pos, vel, omega, q, qdot = _obs_tensors(obs, dev)
    R = quat_to_rotmat(quat, dev)
    rpy = quat_to_zyx(quat, dev)
    q_legs = q.reshape(4, 3)
    qd_legs = qdot.reshape(4, 3)

    p_bf, J = leg_fk(robot, q_legs)
    pos_base_feet = p_bf @ R.T
    rel = torch.linalg.cross(omega.expand(4, 3), p_bf) + torch.einsum("lij,lj->li", J, qd_legs)
    if vel_quirk:
        rel = rel + (vel - R.T @ vel)[None, :]
    return OracleKin(
        R=R,
        rpy=rpy,
        pos_base=pos,
        vel_base=vel,
        omega_body=omega,
        p_bf=p_bf,
        pos_feet=pos + pos_base_feet,
        pos_base_feet=pos_base_feet,
        vel_rel_base=rel,
        thighs=thigh_pos(robot, q_legs),
        J=J,
    )


# ---------------------------------------------------------------- gait


def gait_phase(gait: OracleGait, cfg: OracleConfig, tick: int):
    it = (tick // cfg.iterations_between_mpc) % gait.num_segments
    period = cfg.iterations_between_mpc * gait.num_segments
    return it, (tick % period) / period


def gait_table(gait: OracleGait, cfg: OracleConfig, tick: int):
    it, _ = gait_phase(gait, cfg, tick)
    steps = torch.arange(cfg.horizon, device=gait.stance_offsets.device)
    seg = (steps + 1 + it) % gait.num_segments
    cur = seg[:, None] - gait.stance_offsets[None, :]
    cur = torch.where(cur < 0, cur + gait.num_segments, cur)
    return (cur < gait.stance_durations[None, :]).to(F64).reshape(-1)


def _window(phase, off, dur):
    st = phase - off
    st = torch.where(st < 0, st + 1.0, st)
    # dur == 0 (STANDING's zero swing duration) yields 0, not 0/0.
    safe_dur = torch.where(dur > 0, dur, torch.ones_like(dur))
    return torch.where((st > dur) | (dur <= 0), torch.zeros_like(st), st / safe_dur)


def swing_state(gait: OracleGait, cfg: OracleConfig, tick: int):
    _, phase = gait_phase(gait, cfg, tick)
    off = (gait.stance_offsets + gait.stance_durations).to(F64) / gait.num_segments
    off = torch.where(off > 1.0, off - 1.0, off)
    dur = 1.0 - gait.stance_durations.to(F64) / gait.num_segments
    return _window(phase, off, dur)


def swing_time(gait: OracleGait, cfg: OracleConfig) -> float:
    return cfg.dt_gait * (gait.num_segments - int(gait.stance_durations[0]))


def stance_time(gait: OracleGait, cfg: OracleConfig) -> float:
    return cfg.dt_gait * int(gait.stance_durations[0])


# ---------------------------------------------------------------- QP oracle


def _mv(A, v):
    """Batched matrix-vector product, as the row vector v^T times A^T: each
    row of a batch then rounds on the CPU as it does alone (``A @ v`` takes
    a GEMV path for one row and a batched GEMM for several, which round
    differently)."""
    return (v[..., None, :] @ A.mT)[..., 0, :]


def solve_qp_kkt(H, g, mu, fz_max, gait_tbl, tol=1e-10, max_iter=60, device="cuda",
                 return_iterations=False):
    """Solve the condensed MPC QP to high accuracy, float64.

    Same mathematical problem as the reference solve (ref mpc.py:262-290):
    swing-leg forces pinned to zero (their implied constraints are
    0 <= fz <= 0 and |fx|,|fy| <= 0), stance feet in the friction pyramid.

    ``H`` (n,n) or (B,n,n), ``g`` and ``gait_tbl`` with the same leading
    dimension.  Returns (U, kkt) where kkt = (stationarity, primal,
    complementarity) max-residuals for self-certification, (3,) or (B,3).
    Each scenario of a batch leaves the loop when its own certificate is
    below ``tol``, and follows the iterates it would follow alone.  Where
    the normal matrix's Cholesky factorisation fails, a single QP raises
    ``torch.linalg.LinAlgError``; in a batch that scenario's U and kkt
    become NaN and the others go on.  ``return_iterations`` appends each
    scenario's count of interior-point steps.
    """
    H, g, gait_tbl = (_f64(t, device) for t in (H, g, gait_tbl))
    single = g.dim() == 1
    if single:
        H, g, gait_tbl = H[None], g[None], gait_tbl[None]
    B, n = g.shape
    h_steps = n // 12
    stance = gait_tbl.reshape(B, h_steps * 4)
    mv = torch.repeat_interleave(gait_tbl, 3, dim=-1)

    Hm = H * (mv[:, :, None] * mv[:, None, :]) + torch.diag_embed(1.0 - mv)
    gm = g * mv

    rows = _f64(
        [
            [-1, 0, -mu],
            [1, 0, -mu],
            [0, -1, -mu],
            [0, 1, -mu],
            [0, 0, -1],
            [0, 0, 1],
        ],
        device,
    )
    # Dense constraint matrix over stance blocks only: block k (step, leg)
    # holds rows 6k..6k+5 and columns 3k..3k+2.
    nb = h_steps * 4
    m = nb * 6
    G_blocks = rows[None, None] * stance[:, :, None, None]  # (B,nb,6,3)
    G = torch.zeros(B, nb, 6, nb, 3, dtype=F64, device=device)
    k = torch.arange(nb, device=device)
    G[:, k, :, k, :] = G_blocks.transpose(0, 1)
    G = G.reshape(B, m, n)
    GT = G.transpose(-1, -2)
    h_stance = _f64([0, 0, 0, 0, 0, fz_max], device)
    h_vec = torch.where(stance[..., None] > 0, h_stance, torch.ones_like(h_stance))
    h_vec = h_vec.reshape(B, m)
    ridge = 1e-13 * torch.eye(n, dtype=F64, device=device)

    x = torch.zeros(B, n, dtype=F64, device=device)
    s = torch.clamp(h_vec, min=1.0)
    lam = torch.ones(B, m, dtype=F64, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    failed = torch.zeros_like(active)
    iterations = torch.zeros(B, dtype=torch.int64, device=device)

    def residuals(x, s, lam):
        r_d = _mv(Hm, x) + gm + _mv(GT, lam)
        r_p = _mv(G, x) + s - h_vec
        kkt = torch.stack([r_d.abs().amax(-1), r_p.abs().amax(-1), (s * lam).abs().amax(-1)], -1)
        return r_d, r_p, kkt

    def max_step(z, dz):
        ratio = torch.where(dz < 0, -z / dz, torch.full_like(z, float("inf")))
        return ratio.amin(-1).clamp(max=1.0)

    for _ in range(max_iter):
        r_d, r_p, kkt = residuals(x, s, lam)
        active &= ~(kkt.amax(-1) < tol)
        mu_gap = (s * lam).sum(-1) / m
        d = lam / s
        M = Hm + GT @ (d[..., None] * G) + ridge
        L, info = torch.linalg.cholesky_ex(M)
        failed |= active & (info != 0)
        active &= info == 0
        if not bool(active.any()):
            break

        def solve_kkt(r_c):
            rhs = -r_d - _mv(GT, (lam * r_p - r_c) / s)
            y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
            dx = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
            ds = -r_p - _mv(G, dx)
            dlam = (-r_c - lam * ds) / s
            return dx, ds, dlam

        dx_a, ds_a, dlam_a = solve_kkt(s * lam)
        a_aff = torch.minimum(max_step(s, ds_a), max_step(lam, dlam_a))[:, None]
        mu_aff = ((s + a_aff * ds_a) * (lam + a_aff * dlam_a)).sum(-1) / m
        sigma = (mu_aff / torch.clamp(mu_gap, min=1e-16)) ** 3
        dx, ds, dlam = solve_kkt(s * lam + ds_a * dlam_a - (sigma * mu_gap)[:, None])
        a = 0.99 * torch.minimum(max_step(s, ds), max_step(lam, dlam))
        a = torch.clamp(a, max=1.0)[:, None]
        step = active[:, None]
        iterations += active
        x = torch.where(step, x + a * dx, x)
        s = torch.where(step, torch.clamp(s + a * ds, min=1e-300), s)
        lam = torch.where(step, torch.clamp(lam + a * dlam, min=1e-300), lam)

    _, _, kkt = residuals(x, s, lam)
    U = x * mv
    nan = torch.full_like(U, float("nan"))
    U = torch.where(failed[:, None], nan, U)
    kkt = torch.where(failed[:, None], nan[:, :3], kkt)
    if single:
        if bool(failed[0]):
            raise torch.linalg.LinAlgError("the normal matrix is not positive definite")
        U, kkt, iterations = U[0], kkt[0], iterations[0]
    return (U, kkt, iterations) if return_iterations else (U, kkt)


# ---------------------------------------------------------------- controller


class OracleController:
    """Stateful float64 controller with reference-identical semantics.

    One instance drives one robot, on the device its ``robot`` was built
    on; the MuJoCo example and the lockstep tests both use it.  State
    layout mirrors SURVEY.md §2.2's carry inventory; its scalars and the
    per-leg swing flags and clocks are host values.
    """

    def __init__(self, robot: OracleRobot, cfg: OracleConfig, gait: OracleGait):
        self.robot = robot
        self.cfg = cfg
        self.gait = gait
        self.device = robot.device
        # MPC carry
        self.forces = torch.zeros(12, dtype=F64, device=self.device)
        self.xpos_des = 0.0
        self.ypos_des = 0.0
        self.yaw_des = 0.0
        self.roll_int = 0.0
        self.pitch_int = 0.0
        self.first_run = True
        # swing carry
        self.is_first_swing = np.ones(4, bool)
        self.remaining = np.zeros(4)
        self.foot_init = torch.zeros(4, 3, dtype=F64, device=self.device)
        self.foot_final = torch.zeros(4, 3, dtype=F64, device=self.device)
        self._t_sw = swing_time(gait, cfg)
        self._t_st = stance_time(gait, cfg)
        # debug
        self.last_kkt = None

    # --- MPC internals -------------------------------------------------

    def _reference_traj(self, x_t, vel_des_world, yaw_rate):
        """``x_t`` and ``vel_des_world`` on the host; the (13h,) reference
        on the device."""
        cfg, robot = self.cfg, self.robot
        dt = cfg.dt_predict
        self.xpos_des = float(np.clip(self.xpos_des, x_t[3] - 0.1, x_t[3] + 0.1))
        self.ypos_des = float(np.clip(self.ypos_des, x_t[4] - 0.1, x_t[4] + 0.1))
        if abs(x_t[9]) > 0.2:
            self.pitch_int += dt * (0.0 - x_t[1]) / x_t[9]
        if abs(x_t[10]) > 0.1:
            self.roll_int += dt * (0.0 - x_t[0]) / x_t[10]
        self.pitch_int = float(np.clip(self.pitch_int, -0.25, 0.25))
        self.roll_int = float(np.clip(self.roll_int, -0.25, 0.25))

        steps = torch.arange(cfg.horizon, dtype=F64, device=self.device)
        X = torch.zeros(cfg.horizon, 13, dtype=F64, device=self.device)
        X[:, 0] = float(x_t[10] * self.roll_int)
        X[:, 1] = float(x_t[9] * self.pitch_int)
        X[:, 2] = self.yaw_des + dt * yaw_rate * steps
        X[:, 3] = self.xpos_des + dt * float(vel_des_world[0]) * steps
        X[:, 4] = self.ypos_des + dt * float(vel_des_world[1]) * steps
        X[:, 5] = robot.base_height_des
        X[:, 8] = yaw_rate
        X[:, 9] = float(vel_des_world[0])
        X[:, 10] = float(vel_des_world[1])
        X[:, 12] = -cfg.gravity
        return X.reshape(-1)

    def _condensed_qp(self, x_t, yaw, r_feet, X_ref):
        """(H, g) of the condensed QP; ``x_t`` (13,) or (B,13), ``yaw`` ()
        or (B,), ``r_feet`` (4,3) or (B,4,3), ``X_ref`` (13h,) or (B,13h)."""
        cfg, robot, dev = self.cfg, self.robot, self.device
        x_t, yaw, r_feet, X_ref = (_f64(t, dev) for t in (x_t, yaw, r_feet, X_ref))
        single = x_t.dim() == 1
        if single:
            x_t, yaw, r_feet, X_ref = x_t[None], yaw.reshape(1), r_feet[None], X_ref[None]
        B = x_t.shape[0]
        h = cfg.horizon
        eye3 = torch.eye(3, dtype=F64, device=dev)
        eye13 = torch.eye(13, dtype=F64, device=dev)
        Rz = rot_z(yaw, dev)
        inv_I = torch.linalg.inv(Rz @ robot.inertia @ Rz.transpose(-1, -2))
        Ac = torch.zeros(B, 13, 13, dtype=F64, device=dev)
        Ac[:, 0:3, 6:9] = Rz.transpose(-1, -2)
        Ac[:, 3:6, 9:12] = eye3
        Ac[:, 11, 12] = 1.0
        Bc = torch.zeros(B, 13, 12, dtype=F64, device=dev)
        for l in range(4):
            Bc[:, 6:9, 3 * l : 3 * l + 3] = inv_I @ skew(r_feet[:, l], dev)
            Bc[:, 9:12, 3 * l : 3 * l + 3] = eye3 / robot.mass
        dt = cfg.dt_predict
        A2 = Ac @ Ac
        Ad = eye13 + Ac * dt + A2 * (dt * dt / 2)
        Bd = (eye13 * dt + Ac * (dt * dt / 2) + A2 * (dt**3 / 6)) @ Bc

        pows = [eye13.expand(B, 13, 13)]
        for _ in range(h):
            pows.append(pows[-1] @ Ad)
        Sx = torch.cat(pows[1 : h + 1], dim=1)
        Su = torch.zeros(B, 13 * h, 12 * h, dtype=F64, device=dev)
        M = [pows[k] @ Bd for k in range(h)]
        for i in range(h):
            for j in range(i + 1):
                Su[:, 13 * i : 13 * i + 13, 12 * j : 12 * j + 12] = M[i - j]
        q_bar = cfg.q_diag.repeat(h)
        SuT = Su.transpose(-1, -2)
        H = 2.0 * (SuT @ (q_bar[:, None] * Su)
                   + cfg.r_scalar * torch.eye(12 * h, dtype=F64, device=dev))
        g = 2.0 * _mv(SuT, q_bar * (_mv(Sx, x_t) - X_ref))
        return (H[0], g[0]) if single else (H, g)

    def _mpc_update(self, kin: OracleKin, x_t, vel_des_world, yaw_rate, tick, table):
        """``x_t`` (13,) and ``vel_des_world`` (3,) on the host."""
        cfg = self.cfg
        if self.first_run:
            self.xpos_des = 0.0
            self.ypos_des = 0.0
            self.yaw_des = float(x_t[2])
            self.first_run = False
        else:
            self.xpos_des += cfg.dt_control * vel_des_world[0]
            self.ypos_des += cfg.dt_control * vel_des_world[1]
            self.yaw_des = float(x_t[2] + cfg.dt_control * yaw_rate)

        if tick % cfg.iterations_between_mpc == 0:
            X_ref = self._reference_traj(x_t, vel_des_world, yaw_rate)
            H, g = self._condensed_qp(x_t, kin.rpy[2], kin.pos_base_feet, X_ref)
            # Degrade gracefully on a failed solve (indefinite H from a wild
            # estimated state, non-finite data): hold the previous GRFs, the
            # reference's implicit behavior (ref linear_mpc/mpc.py:99,108).
            try:
                U, kkt = solve_qp_kkt(H, g, cfg.mu, self.robot.fz_max, table,
                                      device=self.device)
                if bool(torch.isfinite(U).all()):
                    self.last_kkt = kkt
                    self.forces = U[:12]
            except torch.linalg.LinAlgError:
                pass
        return self.forces

    # --- swing internals ----------------------------------------------

    def _swing_targets(self, kin: OracleKin, states, vel_cmd_base, yaw_rate):
        """``states`` on the host; targets on the device."""
        cfg, robot = self.cfg, self.robot
        t_sw, t_st = self._t_sw, self._t_st
        pos_t = torch.zeros(4, 3, dtype=F64, device=self.device)
        vel_t = torch.zeros(4, 3, dtype=F64, device=self.device)
        vel_cmd = _f64(vel_cmd_base, self.device)
        vel_des_world = kin.R @ vel_cmd
        rotz = rot_z(yaw_rate * 0.5 * t_st, self.device)

        for leg in range(4):
            if states[leg] <= 0:
                continue
            if self.is_first_swing[leg]:
                self.remaining[leg] = t_sw
            else:
                self.remaining[leg] -= cfg.dt_control

            thigh_c = rotz @ kin.thighs[leg]
            final = (
                kin.pos_base
                + kin.R @ (thigh_c + vel_cmd * float(self.remaining[leg]))
                + 0.5 * t_st * kin.vel_base
                + 0.03 * (kin.vel_base - vel_des_world)
            )
            coef = 0.5 * kin.pos_base[2] / cfg.gravity
            final[0] += coef * kin.vel_base[1] * yaw_rate
            final[1] += coef * (-kin.vel_base[0] * yaw_rate)
            final[2] = robot.touchdown_z
            self.foot_final[leg] = final
            if self.is_first_swing[leg]:
                self.is_first_swing[leg] = False
                self.foot_init[leg] = kin.pos_feet[leg]
            if states[leg] >= 1.0:
                self.is_first_swing[leg] = True

            # Two-segment cubic Hermite with zero knot velocities.
            t = t_sw - self.remaining[leg]
            half = t_sw / 2
            mid = 0.5 * (self.foot_init[leg] + self.foot_final[leg])
            mid[2] = robot.swing_height
            if t < half:
                p0, p1, s = self.foot_init[leg], mid, t
            else:
                p0, p1, s = mid, self.foot_final[leg], t - half
            u = float(np.clip(s / half, 0.0, 1.0))
            pos_w = p0 + (3 * u * u - 2 * u**3) * (p1 - p0)
            vel_w = (6 * u - 6 * u * u) / half * (p1 - p0)

            pos_t[leg] = kin.R.T @ (pos_w - kin.pos_base)
            vel_t[leg] = kin.R.T @ (vel_w - kin.vel_base)
        return pos_t, vel_t

    def _torques(self, kin: OracleKin, states, pos_t, vel_t):
        robot = self.robot
        tau = torch.zeros(12, dtype=F64, device=self.device)
        for leg in range(4):
            if states[leg] != 0:
                f_w = robot.kp_swing * (
                    kin.R @ pos_t[leg] - kin.R @ kin.p_bf[leg]
                ) + robot.kd_swing * (kin.R @ vel_t[leg] - kin.R @ kin.vel_rel_base[leg])
            else:
                f_w = -self.forces[3 * leg : 3 * leg + 3]
            tau[3 * leg : 3 * leg + 3] = kin.J[leg].T @ (kin.R.T @ f_w)
        return tau

    # --- public tick ---------------------------------------------------

    def step(self, obs: dict, vel_cmd_base, yaw_rate, tick: int):
        """One 1 kHz tick.  ``obs`` holds numpy arrays or tensors.  Returns
        a dict with torques/forces/targets (tensors on the device)."""
        kin = kin_update(self.robot, obs)
        states = swing_state(self.gait, self.cfg, tick)
        table = gait_table(self.gait, self.cfg, tick)
        vel_cmd_base = _f64(vel_cmd_base, self.device)
        vel_des_world = kin.R @ vel_cmd_base
        host = torch.cat([states, kin.rpy, kin.pos_base, kin.omega_body, kin.vel_base,
                          vel_des_world]).cpu().numpy()
        states_h, x_t, vel_des_h = host[:4], np.append(host[4:16], -self.cfg.gravity), host[16:]
        forces = self._mpc_update(kin, x_t, vel_des_h, yaw_rate, tick, table)
        pos_t, vel_t = self._swing_targets(kin, states_h, vel_cmd_base, yaw_rate)
        tau = self._torques(kin, states_h, pos_t, vel_t)
        return {
            "torques": tau,
            "forces": forces.clone(),
            "swing_states": states,
            "pos_targets": pos_t,
            "vel_targets": vel_t,
            "kin": kin,
        }
