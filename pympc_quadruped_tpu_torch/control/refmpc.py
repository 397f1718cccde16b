"""Reference-trajectory generation (port of ``control/refmpc.py``).

The reference's mutable ``ModelPredictiveController`` state is the explicit
:class:`MpcCarry`, threaded through pure functions with a leading scenario
axis.  Reproduced reference semantics as in the JAX module (ref
``linear_mpc/mpc.py:83-170``): world-frame desired velocity from the full
base rotation, the first-run latch, +-0.1 m clamping of the desired x/y on
solve ticks, the roll/pitch compensation integrators with dt_predict, and
the X_ref rows with ``x[12] = -g``.  :func:`build_qp` is the condensed QP
build of the f32 solvers, :func:`build_qp_ff` the float64 build of the
parity path (``solver="ipm_parity"``), and :func:`solve_mpc` a
single-scenario condense-and-solve with the IPM or the plain ADMM.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.models.command import Command
from pympc_quadruped_tpu_torch.models.mpc import NUM_STATE, MpcParams
from pympc_quadruped_tpu_torch.models.robots import RobotParams
from pympc_quadruped_tpu_torch.ops import condense, srb
from pympc_quadruped_tpu_torch.ops.kin import KinState
from pympc_quadruped_tpu_torch.ops.qp import admm, admm_cuda, cones, ipm
from pympc_quadruped_tpu_torch.tree import tree_map


@dataclass
class MpcCarry:
    contact_forces: torch.Tensor  # (12,) currently-held GRFs
    xpos_des: torch.Tensor
    ypos_des: torch.Tensor
    yaw_des: torch.Tensor
    roll_comp_int: torch.Tensor   # the reference's roll_init integrator
    pitch_comp_int: torch.Tensor  # the reference's pitch_init integrator
    first_run: torch.Tensor       # bool
    # Warm start: the previous solve's full-horizon primal (12h,) and cone
    # row duals (20h,) in problem units; zeros = cold start / fault reset.
    qp_primal: torch.Tensor
    qp_dual: torch.Tensor

    @staticmethod
    def init(horizon: int = 10, device="cuda") -> "MpcCarry":
        f32 = dict(dtype=torch.float32, device=device)
        z = torch.tensor(0.0, **f32)
        return MpcCarry(
            contact_forces=torch.zeros(12, **f32),
            xpos_des=z, ypos_des=z.clone(), yaw_des=z.clone(),
            roll_comp_int=z.clone(), pitch_comp_int=z.clone(),
            first_run=torch.tensor(True, device=device),
            qp_primal=torch.zeros(12 * horizon, **f32),
            qp_dual=torch.zeros(20 * horizon, **f32),
        )


def integrate_desired(carry: MpcCarry, kin: KinState, cmd: Command, mpc: MpcParams):
    """Every-tick desired-state integration (ref mpc.py:83-92), batched."""
    vel_des_world = (kin.R_base @ cmd.vel_base_des[..., None])[..., 0]
    yaw = kin.rpy_base[..., 2]
    first = carry.first_run
    zero = torch.zeros_like(yaw)
    xpos = torch.where(first, zero, carry.xpos_des + mpc.dt_control * vel_des_world[..., 0])
    ypos = torch.where(first, zero, carry.ypos_des + mpc.dt_control * vel_des_world[..., 1])
    yaw_des = torch.where(first, yaw, yaw + mpc.dt_control * cmd.yaw_turn_rate)
    return (
        dataclasses.replace(carry, xpos_des=xpos, ypos_des=ypos, yaw_des=yaw_des,
                            first_run=torch.zeros_like(first)),
        vel_des_world,
    )


def reference_trajectory(
    carry: MpcCarry,
    x_t: torch.Tensor,
    vel_des_world: torch.Tensor,
    cmd: Command,
    mpc: MpcParams,
    robot: RobotParams,
    gait_table: torch.Tensor | None = None,
    ground_z: torch.Tensor | None = None,
):
    """Solve-tick X_ref build, (...,h,13); also returns the updated carry.

    With ``mpc.ground_adaptive_height`` and ``ground_z`` the height row is
    ``ground_z + base_height_des``; with ``gait_table`` the height and
    vertical-velocity rows become flight-aware (:func:`_flight_rows`), a
    bitwise no-op for gaits without a full-flight step."""
    h = mpc.horizon
    dt = mpc.dt_predict

    xpos = torch.clamp(carry.xpos_des, x_t[..., 3] - mpc.max_pos_error,
                       x_t[..., 3] + mpc.max_pos_error)
    ypos = torch.clamp(carry.ypos_des, x_t[..., 4] - mpc.max_pos_error,
                       x_t[..., 4] + mpc.max_pos_error)

    vx, vy = x_t[..., 9], x_t[..., 10]
    pitch_int = torch.where(
        torch.abs(vx) > 0.2,
        carry.pitch_comp_int + dt * (0.0 - x_t[..., 1]) / vx,
        carry.pitch_comp_int,
    )
    roll_int = torch.where(
        torch.abs(vy) > 0.1,
        carry.roll_comp_int + dt * (0.0 - x_t[..., 0]) / vy,
        carry.roll_comp_int,
    )
    sat = mpc.comp_saturation
    pitch_int = torch.clamp(pitch_int, -sat, sat)
    roll_int = torch.clamp(roll_int, -sat, sat)
    roll_comp = vy * roll_int
    pitch_comp = vx * pitch_int

    z_des = robot.base_height_des
    if mpc.ground_adaptive_height and ground_z is not None:
        z_des = ground_z + robot.base_height_des

    steps = torch.arange(h, dtype=torch.float32, device=x_t.device)
    col = lambda v: v[..., None].expand(v.shape + (h,))
    zero = torch.zeros(x_t.shape[:-1] + (h,), dtype=x_t.dtype, device=x_t.device)
    rows = [zero] * NUM_STATE
    rows[0] = col(roll_comp)
    rows[1] = col(pitch_comp)
    rows[2] = carry.yaw_des[..., None] + dt * cmd.yaw_turn_rate[..., None] * steps
    rows[3] = xpos[..., None] + dt * vel_des_world[..., 0:1] * steps
    rows[4] = ypos[..., None] + dt * vel_des_world[..., 1:2] * steps
    rows[5] = col(z_des)
    rows[8] = col(cmd.yaw_turn_rate)
    rows[9] = col(vel_des_world[..., 0])
    rows[10] = col(vel_des_world[..., 1])
    rows[12] = col((-mpc.gravity).expand_as(vx))
    if gait_table is not None:
        rows[5], rows[11] = _flight_rows(gait_table, z_des, mpc)
    X = torch.stack(rows, dim=-1)

    new_carry = dataclasses.replace(
        carry, xpos_des=xpos, ypos_des=ypos,
        roll_comp_int=roll_int, pitch_comp_int=pitch_int,
    )
    return new_carry, X


# Amplitude of the flight-reference arc relative to the dt_predict-ballistic
# one (measured in the JAX package's SRB sweeps; see control/refmpc.py there).
FLIGHT_APEX_SCALE = 2.0


def _flight_rows(gait_table: torch.Tensor, z_des, mpc: MpcParams):
    """Flight-aware (z_ref, vz_ref) horizon rows (...,h) from the stance
    table (...,4h): run-length decomposition of the any-contact vector with
    the circular join, ballistic arcs on flight steps, a vz ramp on stance
    steps of flight-bearing gaits, constant rows otherwise."""
    h = mpc.horizon
    dt = mpc.dt_predict
    g = mpc.gravity
    lead = gait_table.shape[:-1]
    contact = gait_table.reshape(lead + (h, 4)).amax(dim=-1) > 0.5      # (...,h)

    zero_i = torch.zeros(lead, dtype=torch.int32, device=gait_table.device)
    pos = [zero_i]
    for k in range(1, h):
        pos.append(torch.where(contact[..., k] == contact[..., k - 1], pos[-1] + 1, zero_i))
    tail = [zero_i] * h
    for k in range(h - 2, -1, -1):
        tail[k] = torch.where(contact[..., k] == contact[..., k + 1], tail[k + 1] + 1, zero_i)
    pos = torch.stack(pos, dim=-1)
    L = pos + torch.stack(tail, dim=-1) + 1

    # Circular join: the table is a rotated view of the gait cycle, so a
    # window straddling the view boundary is one window.
    first_len = L[..., :1]
    last_len = L[..., h - 1 :]
    wrap = (contact[..., 0] == contact[..., h - 1])[..., None]
    idx = torch.arange(h, device=gait_table.device)
    in_first = idx < first_len
    in_last = idx >= h - last_len
    pos = torch.where(wrap & in_first, pos + last_len, pos)
    L = torch.where(wrap & (in_first | in_last),
                    torch.clamp(first_len + last_len, max=h), L)
    j = pos.float()
    L = L.float()

    has_flight = ((~contact).any(dim=-1) & contact.any(dim=-1))[..., None]
    flight = ~contact
    vz_to_flight = 0.5 * g * dt * (L - 1.0)
    L_flight = torch.where(flight, L, torch.zeros_like(L)).amax(dim=-1, keepdim=True)
    vz_to_stance = 0.5 * g * dt * torch.clamp(L_flight - 1.0, min=0.0)

    s = FLIGHT_APEX_SCALE
    z_des = torch.as_tensor(z_des)[..., None]
    z_flight = z_des + s * (dt * j * vz_to_flight - 0.5 * g * dt * dt * j * (j - 1.0))
    vz_flight = s * (vz_to_flight - g * dt * j)
    vz_stance = s * (-vz_to_stance + 2.0 * vz_to_stance * (j + 0.5) / L)

    z_ref = torch.where(flight, z_flight, z_des)
    vz_ref = torch.where(flight, vz_flight, vz_stance)
    z_ref = torch.where(has_flight, z_ref, z_des.expand_as(z_ref))
    vz_ref = torch.where(has_flight, vz_ref, torch.zeros_like(vz_ref))
    return z_ref, vz_ref


def build_qp(
    robot: RobotParams,
    mpc: MpcParams,
    x_t: torch.Tensor,            # (B,13)
    yaw: torch.Tensor,            # (B,)
    pos_base_feet: torch.Tensor,  # (B,4,3)
    X_ref: torch.Tensor,          # (B,h,13) or (B,13h)
    gait_table: torch.Tensor,     # (B,4h)
):
    """(Ac,Bc) -> (Ad,Bd) -> condensed (H, g) with swing-leg masking
    applied, batched; ``robot`` carries the scenario axis.

    On float32 CUDA operands at a horizon the kernel plans for, one launch
    of the condensing kernel (``admm_cuda.condense``) builds the masked
    (H, g); otherwise (the CPU, a longer horizon) the plain
    ``condense.condense`` and ``cones.mask_cost``.

    Returns H (B,12h,12h), g (B,12h) and the stance variable mask mv (B,12h).
    """
    Ac, Bc = srb.state_space(robot, yaw, pos_base_feet)
    Ad, Bd = srb.discretize(Ac, Bc, mpc.dt_predict)
    mv = cones.variable_mask(gait_table, mpc)
    if admm_cuda.condenses_on_card(x_t, mpc, Ad, Bd, X_ref, mv):
        H, g = admm_cuda.condense(Ad, Bd, x_t, X_ref, mv, mpc)
    else:
        H, g = cones.mask_cost(*condense.condense(Ad, Bd, x_t, X_ref, mpc), mv)
    return H, g, mv


def build_qp_ff(
    robot: RobotParams,
    mpc: MpcParams,
    x_t: torch.Tensor,            # (B,13)
    yaw: torch.Tensor,            # (B,)
    pos_base_feet: torch.Tensor,  # (B,4,3)
    X_ref: torch.Tensor,          # (B,h,13) or (B,13h)
    gait_table: torch.Tensor,     # (B,4h)
):
    """:func:`build_qp` with float64 condensing (``condense.condense_ff``):
    returns (H, H_lo, g, g_lo, mv), where H + H_lo reproduces float64
    condensing to ~1e-14 relative, as the parity IPM needs to meet the
    BASELINE 1e-3 end-to-end GRF bar."""
    Ac, Bc = srb.state_space(robot, yaw, pos_base_feet)
    Ad, Bd = srb.discretize(Ac, Bc, mpc.dt_predict)
    H_hi, H_lo, g_hi, g_lo = condense.condense_ff(Ad, Bd, x_t, X_ref, mpc)
    mv = cones.variable_mask(gait_table, mpc)
    # The 0/1 mask and the identity ridge are exact in f32, so both words
    # are masked verbatim.
    H_hi, g_hi = cones.mask_cost(H_hi, g_hi, mv)
    H_lo = H_lo * mv[:, :, None] * mv[:, None, :]
    return H_hi, H_lo, g_hi, g_lo * mv, mv


def solve_mpc(
    robot: RobotParams,
    mpc: MpcParams,
    x_t: torch.Tensor,            # (13,)
    yaw: torch.Tensor,            # ()
    pos_base_feet: torch.Tensor,  # (4,3)
    X_ref: torch.Tensor,          # (h,13) or (13h,)
    gait_table: torch.Tensor,     # (4h,)
    solver: str = "ipm",
    ipm_cfg: ipm.IpmConfig = ipm.IpmConfig(),
    admm_cfg: admm.AdmmConfig = admm.AdmmConfig(),
) -> torch.Tensor:
    """Single-scenario condensed solve with ``solver`` ``"ipm"`` or
    ``"admm"`` -> (12,) first-step GRFs.  ``robot`` is unbatched; for
    batches use ``engine.solve_scenarios``."""
    if solver not in ("ipm", "admm"):
        raise ValueError(f"unknown solver {solver!r}")
    add = lambda t: t[None]
    robot_b = tree_map(add, robot)
    H, g, mv = build_qp(robot_b, mpc, x_t[None], yaw.reshape(1), pos_base_feet[None],
                        X_ref.reshape(1, -1), gait_table[None])
    if solver == "ipm":
        G, h_vec, _ = cones.block_constraints(gait_table[None], robot_b.fz_max, mpc)
        U = ipm.solve_batch(H, g, G, h_vec, ipm_cfg)
    else:
        A, l, u = admm.admm_constraints(gait_table[None], robot_b.fz_max, mpc)
        U = admm.solve_batch(H, g, A, l, u, admm_cfg)
    return (U * mv)[0, :12]  # exact zeros on swing legs
