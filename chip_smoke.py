"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each or more; any failure exits non-zero and prints no
result):

1. device and build: a CUDA card, its name and power limit, every kernel
   built from ``pympc_quadruped_tpu_torch/csrc`` (one nvcc per source, in
   parallel) with its ptxas report, the Riccati and invert kernels'
   resident scenarios per SM and shared memory per block, and the iterate
   kernel's launch at B=4096 (threads, persistent blocks, shared memory)
   with its entry's ptxas line, which must show no spills;
2. Riccati kernel vs plain: the Riccati-ADMM kernel against its plain
   PyTorch version on the same random h=16 problems, at B=4096 and at a
   ragged B=130: cold, warm-started, and with per-scenario rho;
3. the Riccati closed loop: Aliengo, h=16, TROTTING16, 1.2 m/s, B=4096
   jittered scenarios, 3000 ticks with ``solver="riccati"``; every solve
   tick must launch the kernel and >= 99% of scenarios hold the trot band;
4. Riccati times with CUDA events at h=16, B=4096: the kernel alone and
   its plain version alone on operands prepared once, one whole
   ``solve_batch`` (setup and layout included), and one full 20-tick
   control period;
5. condensed kernels vs plain: on random condensed problems made by the
   port's ``build_qp`` at h=16, B=4096 and B=130, cold and warm-started:
   the invert kernel's f64 residual max|Kinv K - I| within 2x of the plain
   ``spd_inverse``'s, and the ``pallas``, ``pallas_split``,
   ``pallas_fused`` and ``pallas_full`` backends against ``jnp`` with the
   JAX bench's batch kernel gate (bench.py:463-545), per scenario: f64 cost
   no more than 2e-5 above the plain solution's, cone rows within 1e-3
   fz_max, and the predicted CoM trajectory within 1 cm and 10 cm/s.  The
   99th percentile over the batch must meet those bars and the worst
   scenario 5x them: at h=16 the f32 inverse is only a preconditioner
   (max|Kinv K - I| up to ~1 on the worst of 4096 scenarios), so two
   implementations' fixed sweeps stop at different points along the QP's
   weak directions, and the worst of 4096 sits at the bench's f32 noise
   bar.  The two-sided cost difference and first-step fz are printed, not
   gated: equal-cost solutions differ by up to ~10% in one step's fz
   (bench.py:467-473);
6. the condensed closed loop: the same scenarios as phase 3 with the
   default ``solver="admm_fast"`` (``pallas_split`` on the card); the
   invert and iterate kernels must each launch once per solve tick;
7. condensed times with CUDA events: one in-loop h=16 solve at B=4096 per
   backend, each kernel alone against its plain version (and the invert
   kernel against ``torch.linalg.inv``), the invert kernel alone without
   its Newton-Schulz step, one 20-tick period.

The last two lines are the kernel summary and the device record.  Imports
torch, numpy and the port only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pympc_quadruped_tpu_torch import _build, tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.control import refmpc
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.loop import run_ticks
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.ops import condense, lie, srb
from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, admm_fast, riccati, riccati_cuda

B_MAIN, B_RAGGED, HORIZON = 4096, 130, 16
N_TICKS, BAND_TICKS, PERIOD = 3000, 750, 20
# Bars of the TPU kernel against its jnp path (tests/test_riccati_pallas.py:146-151).
FZ_REL_BAR, U_ABS_BAR = 0.02, 1.0
# Condensed bars, the JAX bench's batch kernel gate (bench.py:520, :531,
# :545), for the 99th percentile over a batch (the worst scenario gets
# WORST_FACTOR times each): f64 cost excess over the plain solution,
# relative; cone-row violation [N] as a share of fz_max; predicted CoM
# position [m] and velocity [m/s].  And the invert kernel's f64 residual
# against the plain version's.
COST_BAR, CONE_SHARE, TRAJ_POS_BAR, TRAJ_VEL_BAR, INV_RATIO_BAR = 2e-5, 1e-3, 0.01, 0.10, 2.0
WORST_FACTOR = 5.0
BAND_SHARE = 0.99
# The H100 SXM's published peaks: FP32 outside the tensor cores, and HBM3.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def cuda_ms(fn, warmup=2, reps=10) -> float:
    """Median milliseconds of ``fn()`` on the card, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound_ms(flops: float, nbytes: float):
    """Least time the card could take: the larger of the operations over
    the FP32 peak and the bytes over the memory rate; and which one."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_problem(B, h, seed, dev, mass_spread=0.0):
    """Random h-step Riccati problems in the style of the JAX package's
    kernel tests (tests/test_riccati_pallas.py:25-43), made with numpy."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    mpc = default_mpc_params(h, device=dev)
    robot = tree.tile(aliengo(device=dev), B)
    if mass_spread:
        robot.mass = robot.mass * T(rng.uniform(1 - mass_spread, 1 + mass_spread, B))
    yaw = T(rng.uniform(-0.3, 0.3, B))
    feet = T(np.array([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                       [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]])[None]
             + rng.normal(scale=0.03, size=(B, 4, 3)))
    Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
    x_t = rng.normal(scale=0.2, size=(B, 13))
    x_t[:, 5] += 0.38
    x_t[:, 12] = -9.81
    X_ref = rng.normal(scale=0.2, size=(B, h, 13))
    table = (rng.uniform(size=(B, 4 * h)) > 0.4).astype(np.float32)
    table[:, :4] = 1.0
    u0 = rng.normal(scale=20.0, size=(B, h, 12))
    return mpc, robot, Ad, Bd, T(x_t), T(X_ref), T(table), T(u0)


def riccati_flops(h: int, iterations: int) -> float:
    """FP32 operations of one scenario of the Riccati-ADMM kernel, counted
    from csrc/riccati_admm.cuh: per step the factorization's products and
    12x12 Gauss-Jordan (columns right of the pivot only), per sweep and step
    the cone, affine and rollout work."""
    ns, nu = 13, 12
    gauss_jordan = sum(2 * nu - 1 - kk for kk in range(nu)) * (1 + 2 * (nu - 1))
    factor = 2 * (2 * ns * ns * ns + ns * nu * ns + nu * nu * ns + 2 * nu * ns * ns
                  + nu * ns * nu + ns * ns * nu) + gauss_jordan
    sweep = (2 * (nu * ns + nu * nu + ns * (nu + ns) + nu * ns + ns * (ns + nu))
             + 4 * 40 + 20 * 10)
    return float(h * factor + iterations * h * sweep)


@dataclasses.dataclass
class RiccatiProblem:
    """A random h=16 problem as ``riccati.solve_batch`` hands it to the kernel."""
    mpc: object
    robot: object
    cfg: object
    table: torch.Tensor
    args: tuple           # Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd
    init: tuple | None    # warm start (u0, z0, y0)
    rho_b: torch.Tensor | None

    def kernel(self):
        return riccati_cuda.factor_iterate(*self.args, self.mpc, self.cfg, self.init,
                                           rho_b=self.rho_b)

    def plain(self):
        Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd = self.args
        fac = riccati.lqr_factor(Ad, Bd, hu, m_u, self.mpc)
        return riccati.iterate(fac, Ad, x_t, X_ref, gate, l, u_bnd, self.mpc, self.cfg,
                               self.init, rho_b=self.rho_b)

    def operands(self):
        return riccati_cuda.operands(*self.args, self.mpc, self.cfg, self.init,
                                     rho_b=self.rho_b)


def riccati_problem(B, case, dev, seed=3) -> RiccatiProblem:
    """Phase 2's cases: ``cold`` (default config), ``warm`` (a 20 N random
    warm start), ``rho`` (in-loop config: per-scenario rho over a 30% mass
    spread); and ``inloop`` (in-loop config, nominal mass), phase 4's."""
    mpc, robot, Ad, Bd, x_t, X_ref, table, u0 = random_problem(
        B, HORIZON, seed=seed, dev=dev, mass_spread=0.3 if case == "rho" else 0.0)
    cfg = (riccati.RiccatiConfig.inloop() if case in ("rho", "inloop")
           else riccati.RiccatiConfig())
    h = mpc.horizon
    m_u, gate = riccati.step_gating(table, h)
    l, u_bnd = riccati.step_bounds(table, robot.fz_max, h)
    rho_b = cfg.rho * riccati.rho_scale_from_Bd(Bd, mpc) if cfg.normalize else None
    hu = riccati.input_cost_diag(m_u, mpc, cfg, rho_b=rho_b)
    init = None
    if case == "warm":
        z0 = torch.zeros_like(gate)
        init = (u0, z0, z0.clone())
    return RiccatiProblem(mpc, robot, cfg, table, (Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd),
                          init, rho_b)


def phase_kernel_vs_plain(dev):
    worst = 0.0
    for B in (B_MAIN, B_RAGGED):
        for case in ("cold", "warm", "rho"):
            p = riccati_problem(B, case, dev)
            if case == "rho":
                check(float(p.rho_b.max() / p.rho_b.min()) > 1.5, "rho case: rho_b does not vary")
            U_k, y_k = p.kernel()
            U_p, y_p = p.plain()
            torch.cuda.synchronize()
            h = p.mpc.horizon
            check(tuple(U_k.shape) == (B, h, 12) and tuple(y_k.shape) == (B, h, 20),
                  f"kernel output shapes {tuple(U_k.shape)}, {tuple(y_k.shape)}")
            check(bool(torch.isfinite(U_k).all() and torch.isfinite(y_k).all()),
                  f"B={B} {case}: non-finite kernel output")
            fz_k, fz_p = U_k[:, 0, 2::3], U_p[:, 0, 2::3]
            fz_rel = float(((fz_k - fz_p).abs() / fz_p.abs().clamp(min=20.0)).max())
            u_err = float((U_k - U_p).abs().max())
            worst = max(worst, u_err)
            print(f"phase 2: B={B} {case}: max|dU|={u_err:.3e} N (bar {U_ABS_BAR}), "
                  f"first-step fz rel={fz_rel:.3e} (bar {FZ_REL_BAR})", flush=True)
            check(fz_rel < FZ_REL_BAR and u_err < U_ABS_BAR,
                  f"B={B} {case}: kernel disagrees with the plain version")
    return worst


def jittered_init(robot, B, seed, dev):
    """SRB inits jittered as tests/test_h16_config.py:30-42 does; scenario 0 nominal."""
    state = srb_env.default_init_state(robot)
    rng = np.random.default_rng(seed)
    dpos = np.zeros((B, 3), np.float32)
    dpos[1:, :2] = rng.uniform(-0.01, 0.01, (B - 1, 2))
    dpos[1:, 2] = rng.uniform(-0.005, 0.005, B - 1)
    dvel = np.zeros((B, 3), np.float32)
    dvel[1:] = rng.uniform(-0.02, 0.02, (B - 1, 3))
    return dataclasses.replace(state, pos=state.pos + torch.tensor(dpos, device=dev),
                               vel=state.vel + torch.tensor(dvel, device=dev))


def closed_loop_setup(dev, B=None):
    """The trot scenarios of the closed loops, B_MAIN of them by default."""
    B = B or B_MAIN
    mpc = default_mpc_params(HORIZON, device=dev)
    robot = tree.tile(aliengo(device=dev), B)
    gait = tree.tile(Gaits.trotting16(device=dev), B)
    cmd = tree.tile(Command.trot_forward(1.2, device=dev), B)
    carry = tree.tile(ctrl.init_carry(HORIZON, device=dev), B)
    return mpc, robot, gait, cmd, carry, jittered_init(robot, B, seed=31, dev=dev)


def reset_launches():
    riccati_cuda.LAUNCHES = 0
    for name in admm_cuda.LAUNCHES:
        admm_cuda.LAUNCHES[name] = 0


def phase_closed_loop(dev, solver, phase):
    """3000 ticks of the trot with ``solver``; returns the launch counts of
    the run and the loop state for the timing phase."""
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(dev)
    B = B_MAIN
    diverged = torch.zeros(B, dtype=torch.bool, device=dev)
    vel_err_sum = torch.zeros(B, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for tick in range(N_TICKS):
        R = lie.quat_to_rotmat(state.quat)            # the tick's observed base rotation
        carry, state, out = run_ticks(robot, mpc, gait, cmd, carry, state, tick, 1, solver)
        diverged |= srb_env._diverged(state)
        if tick >= N_TICKS - BAND_TICKS:
            vel_des = (R @ cmd.vel_base_des[..., None])[..., 0]
            vel_err_sum += torch.linalg.vector_norm(state.vel - vel_des, dim=-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}
    n_solves = N_TICKS // PERIOD
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate")
    for name, count in launches.items():
        check(count == (n_solves if name in on_path else 0),
              f"{solver} loop: kernel {name} launched {count} times, expected "
              f"{n_solves if name in on_path else 0}")
    check(tuple(out.contact_forces.shape) == (B, 12) and tuple(out.torques.shape) == (B, 12),
          "closed-loop output shapes")
    check(bool(torch.isfinite(out.torques).all()), "non-finite torques at the last tick")
    vel_err = vel_err_sum / BAND_TICKS
    height, x = state.pos[:, 2], state.pos[:, 0]
    ok = (~diverged) & (vel_err < 0.15) & (height > 0.34) & (height < 0.42) & (x > 2.0)
    share = float(ok.float().mean())
    counts = ", ".join(f"{k} {launches[k]}" for k in on_path)
    print(f"phase {phase}: closed loop solver={solver} B={B} h={HORIZON} {N_TICKS} ticks in "
          f"{wall:.1f} s: {int(ok.sum())}/{B} in band ({share:.4f}, bar {BAND_SHARE}); "
          f"kernel launches {counts}; median vel_err {float(vel_err.median()):.4f} m/s, "
          f"median final height {float(height.median()):.4f} m, median x "
          f"{float(x.median()):.3f} m", flush=True)
    check(share >= BAND_SHARE, f"{solver}: only {share:.4f} of scenarios in the band")
    return launches, (mpc, robot, gait, cmd, carry, state)


def time_period(loop_state, solver):
    mpc, robot, gait, cmd, carry, state = loop_state
    tick = [N_TICKS]

    def period():
        nonlocal carry, state
        carry, state, _ = run_ticks(robot, mpc, gait, cmd, carry, state, tick[0], PERIOD,
                                    solver)
        tick[0] += PERIOD

    return cuda_ms(period)


def phase_times(dev, card, loop_state):
    """Kernel alone (``riccati_cuda.launch`` on operands prepared once) and
    plain alone (``lqr_factor`` + ``iterate`` on the same inputs), in turns
    plain, kernel, kernel, plain; then the whole ``solve_batch`` (gating,
    bounds, input costs and the wrapper's layout included) and one period."""
    p = riccati_problem(B_MAIN, "inloop", dev, seed=5)
    mpc, cfg, h = p.mpc, p.cfg, p.mpc.horizon
    ops = p.operands()
    lib = _build.load("riccati_admm").lib
    stream = torch.cuda.current_stream().cuda_stream
    kernel = lambda: riccati_cuda.launch(lib, ops, h, cfg, stream)
    cuda_ms(p.plain, reps=3)
    cuda_ms(kernel, reps=3)
    ms_kernel = cuda_ms(kernel)
    ms_plain = cuda_ms(p.plain, reps=5)
    Ad, Bd, x_t, X_ref = p.args[:4]
    ms_solve = cuda_ms(lambda: riccati.solve_batch(Ad, Bd, x_t, X_ref, p.table, p.robot.fz_max,
                                                   mpc, cfg, backend="cuda"))
    # Inputs read once and outputs written once (csrc/riccati_admm.cu's operands).
    floats = 13 * 13 + 13 * 12 + 2 * h * 12 + 1 + 13 * h + 13 + 3 * 20 * h + (12 + 40) * h \
        + (12 + 20) * h
    bound, by = bound_ms(B_MAIN * riccati_flops(h, cfg.iterations), 4.0 * B_MAIN * floats)
    print(f"phase 4: h={HORIZON} Riccati-ADMM at B={B_MAIN} (inloop, {cfg.iterations} it): "
          f"kernel alone {ms_kernel:.3f} ms, plain alone (lqr_factor + iterate) "
          f"{ms_plain:.3f} ms, bound {bound:.3f} ms ({by}) [{card}]", flush=True)
    print(f"phase 4: one h={HORIZON} Riccati solve_batch at B={B_MAIN} (kernel backend, setup "
          f"and layout included): {ms_solve:.3f} ms [{card}]", flush=True)
    ms_period = time_period(loop_state, "riccati")
    print(f"phase 4: one {PERIOD}-tick control period (1 solve tick) at B={B_MAIN}, "
          f"solver=riccati: {ms_period:.3f} ms against the 20 ms real-time budget [{card}]",
          flush=True)
    return dict(ms=ms_kernel, plain_ms=ms_plain, solve_ms=ms_solve, bound_ms=bound,
                bound_by=by)


# ---------------------------------------------------------------------------
# The condensed path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CondensedProblem:
    mpc: object
    robot: object
    H: torch.Tensor       # (B,n,n) masked condensed cost
    g: torch.Tensor       # (B,n)
    mv: torch.Tensor      # (B,n) stance variable mask
    table: torch.Tensor   # (B,4h)
    warm: tuple           # (U0 (B,n), lam0 (B,m)) in problem units
    free: torch.Tensor    # (B,13h) Sx x_t: the predicted states with U = 0
    Su: torch.Tensor      # (B,13h,n): the predicted states' response to U


def condensed_problem(B, seed, dev, h=HORIZON) -> CondensedProblem:
    """Trot-like condensed problems (h=16 unless given) from the port's
    build_qp, made with numpy: jittered states near 1.2 m/s, a
    forward-moving reference, the TROTTING16 stance table at a random phase
    per scenario.  Also a warm
    start in problem units: a converged plain solve perturbed by 5 N."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    mpc = default_mpc_params(h, device=dev)
    robot = tree.tile(aliengo(device=dev), B)
    yaw = rng.uniform(-0.3, 0.3, B)
    feet = (np.array([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                      [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]])[None]
            + rng.normal(scale=0.03, size=(B, 4, 3)))
    x_t = np.concatenate([rng.normal(scale=0.05, size=(B, 2)), yaw[:, None],
                          rng.normal(scale=0.02, size=(B, 2)),
                          0.38 + rng.normal(scale=0.01, size=(B, 1)),
                          rng.normal(scale=0.3, size=(B, 3)),
                          1.2 + rng.normal(scale=0.2, size=(B, 1)),
                          rng.normal(scale=0.1, size=(B, 2)), np.full((B, 1), -9.81)], axis=1)
    X_ref = np.zeros((B, h, 13))
    X_ref[:, :, 2] = yaw[:, None]
    X_ref[:, :, 3] = x_t[:, 3:4] + 0.06 * np.arange(h)
    X_ref[:, :, 5] = 0.38
    X_ref[:, :, 9] = 1.2
    X_ref[:, :, 12] = -9.81
    seg = (rng.integers(0, 16, B)[:, None] + np.arange(h)) % 16 < 8       # (B,h)
    table = np.stack([seg, ~seg, ~seg, seg], axis=-1).reshape(B, 4 * h)
    x_t, yaw, feet, table = T(x_t), T(yaw), T(feet), T(table)
    H, g, mv = refmpc.build_qp(robot, mpc, x_t, yaw, feet, T(X_ref), table)
    Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
    Sx, Su = condense.rollout_matrices(Ad, Bd, h)
    U, lam = admm_fast.solve_batch(H, g, table, robot.fz_max, mpc,
                                   admm_fast.AdmmFastConfig(iterations=200), backend="jnp",
                                   return_duals=True)
    noise = T(rng.normal(scale=5.0, size=tuple(U.shape)))
    return CondensedProblem(mpc, robot, H, g, mv, table, ((U + noise) * mv, lam),
                            (Sx @ x_t[..., None])[..., 0], Su)


def inverse_residual(Kinv, K):
    """Per-scenario f64 max|Kinv K - I|."""
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (Kinv.double() @ K.double() - eye).abs().amax(dim=(-1, -2))


def qp_invariants(p: CondensedProblem, U, U_ref):
    """U against U_ref on p, per scenario (float64 tensors): the f64 cost
    excess of U over U_ref and the two-sided cost difference (both relative
    to |cost(U_ref)| + 1), the cone-row violation of U [N], the predicted
    CoM position [m] and velocity [m/s] differences, and the first-step fz
    difference (relative, clamped at 20 N)."""
    Hd, gd = p.H.double(), p.g.double()
    cost = lambda V: (0.5 * (V[:, None] @ Hd @ V[..., None])[:, 0, 0] + (gd * V).sum(-1))
    Um, Urm = (U * p.mv).double(), (U_ref * p.mv).double()
    c, c_ref = cost(Um), cost(Urm)
    fz, fz_ref = Um[:, 2:12:3], Urm[:, 2:12:3]
    P0 = admm_fast.cone_pattern(p.mpc.friction_coef, p.mpc.horizon).double()
    srow, l, u = admm_fast.row_bounds(p.table, p.robot.fz_max, p.mpc.horizon)
    z = Um @ P0.T
    viol = torch.maximum(l - z, torch.where(torch.isfinite(u), z - u, torch.zeros_like(z)))
    dX = ((p.Su.double() @ (Um - Urm)[..., None])[..., 0]).abs().reshape(len(U), -1, 13)
    return {"excess": (c - c_ref) / (c_ref.abs() + 1.0),
            "cost": (c - c_ref).abs() / (c_ref.abs() + 1.0),
            "cone": (viol * srow).clamp(min=0.0).amax(-1),
            "pos": dX[:, :, 3:6].amax((-1, -2)), "vel": dX[:, :, 9:12].amax((-1, -2)),
            "fz": ((fz - fz_ref).abs() / fz_ref.abs().clamp(min=20.0)).amax(-1)}


def p99_max(x: torch.Tensor):
    return float(torch.quantile(x, 0.99)), float(x.max())


def invariants_ok(inv, fz_max) -> bool:
    """The bench's bars for the 99th percentile, WORST_FACTOR x for the max."""
    bars = {"excess": COST_BAR, "cone": CONE_SHARE * fz_max, "pos": TRAJ_POS_BAR,
            "vel": TRAJ_VEL_BAR}
    return all(p99 < bar and worst < WORST_FACTOR * bar
               for key, bar in bars.items() for p99, worst in [p99_max(inv[key])])


def phase_condensed_vs_plain(dev):
    worst = {"invert_spd": 0.0, "iterate": 0.0, "iterate_fused": 0.0, "solve_full": 0.0}
    backend_kernel = {"pallas": "iterate", "pallas_split": "iterate",
                      "pallas_fused": "iterate_fused", "pallas_full": "solve_full"}
    for B in (B_MAIN, B_RAGGED):
        p = condensed_problem(B, 11, dev)
        args = (p.H, p.g, p.table, p.robot.fz_max, p.mpc)
        K = admm_fast.setup(*args, admm_fast.AdmmFastConfig(), invert=False).K
        Kinv_k = admm_cuda.invert_spd(K)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(Kinv_k).all()), f"B={B}: non-finite invert_spd output")
        r_k = float(inverse_residual(Kinv_k, K).max())
        r_p = float(inverse_residual(admm_fast.spd_inverse(K), K).max())
        worst["invert_spd"] = max(worst["invert_spd"], r_k / r_p)
        print(f"phase 5: B={B} invert_spd: f64 max|Kinv K - I| kernel {r_k:.3e}, plain "
              f"{r_p:.3e} (ratio {r_k / r_p:.3f}, bar {INV_RATIO_BAR})", flush=True)
        check(r_k <= INV_RATIO_BAR * r_p, f"B={B}: invert_spd residual above the bar")
        for case, w, cfg in (("cold", None, admm_fast.AdmmFastConfig()),
                             ("warm", p.warm, admm_fast.AdmmFastConfig.inloop())):
            U_p = admm_fast.solve_batch(*args, cfg, backend="jnp", warm=w)
            cone_p = p99_max(qp_invariants(p, U_p, U_p)["cone"])
            fz_max = float(p.robot.fz_max.max())
            for backend, kernel in backend_kernel.items():
                U_k = admm_fast.solve_batch(*args, cfg, backend=backend, warm=w)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(U_k).all()), f"B={B} {backend}: non-finite output")
                inv = qp_invariants(p, U_k, U_p)
                pm = {k: p99_max(v) for k, v in inv.items()}
                worst[kernel] = max(worst[kernel], pm["excess"][1])
                print(f"phase 5: B={B} {case} {backend} (p99 / max): cost excess "
                      f"{pm['excess'][0]:.3e} / {pm['excess'][1]:.3e} (bar {COST_BAR}), cone "
                      f"violation {pm['cone'][0]:.3e} / {pm['cone'][1]:.3e} N (bar "
                      f"{CONE_SHARE * fz_max:g}; plain {cone_p[0]:.3e} / {cone_p[1]:.3e}), "
                      f"predicted CoM {pm['pos'][0]:.2e} / {pm['pos'][1]:.2e} m, "
                      f"{pm['vel'][0]:.2e} / {pm['vel'][1]:.2e} m/s (bars {TRAJ_POS_BAR}, "
                      f"{TRAJ_VEL_BAR}; max {WORST_FACTOR:g}x); diagnostics: |cost diff| "
                      f"{pm['cost'][1]:.3e}, first-step fz rel {pm['fz'][0]:.3e} / "
                      f"{pm['fz'][1]:.3e}", flush=True)
                check(invariants_ok(inv, fz_max),
                      f"B={B} {case} {backend}: kernel disagrees with the plain version")
    return worst


def condensed_flops(n: int, m: int, iterations: int, ns_iters: int, ruiz_iters: int):
    """FP32 operations of one scenario of each condensed kernel, counted from
    csrc/admm.cuh: the Schur recursion's four products per level and its
    Gauss-Jordan leaves, the Newton-Schulz products, per sweep the n x n
    matrix-vector product and the cone and update work, and for the full
    kernel the Ruiz passes."""
    def schur(k):
        if k <= 16:
            return 2 * k * (2 * k) * k
        a, b = k // 2, k - k // 2
        return 4 * a * a * b + 4 * a * b * b + schur(a) + schur(b)

    invert = schur(n) + ns_iters * 4 * n ** 3
    sweeps = iterations * (2 * n * n + (38 + 77) * n // 3)
    full = invert + sweeps + ruiz_iters * 3 * n * n + 60 * n
    return {"invert_spd": invert, "iterate": sweeps, "iterate_fused": invert + sweeps,
            "solve_full": full}


def condensed_bytes(n: int, m: int):
    """Bytes each condensed kernel must move per scenario: its inputs read
    once and its outputs written once (csrc/admm.cu's operands)."""
    vec_in, vec_out = 3 * n + 6 * m, n + m      # q, d, x0 / es, rho, l, u, z0, y0; x, y
    return {"invert_spd": 4 * 2 * n * n, "iterate": 4 * (n * n + vec_in + vec_out),
            "iterate_fused": 4 * (n * n + vec_in + vec_out),
            "solve_full": 4 * (n * n + 2 * n + 4 * m + n + m)}


def phase_condensed_times(dev, card, loop_state):
    p = condensed_problem(B_MAIN, 13, dev)
    mpc, robot, H, g, table, warm = p.mpc, p.robot, p.H, p.g, p.table, p.warm
    del p
    cfg = admm_fast.AdmmFastConfig.inloop()
    B, n = g.shape
    m = 5 * n // 3
    solves, launches = {}, {}
    for backend in ("pallas_split", "pallas_fused", "pallas_full", "jnp"):
        reset_launches()
        solves[backend] = cuda_ms(lambda: admm_fast.solve_batch(
            H, g, table, robot.fz_max, mpc, cfg, backend=backend, warm=warm))
        launches[backend] = dict(admm_cuda.LAUNCHES)
        print(f"phase 7: one in-loop h={HORIZON} condensed solve at B={B} ({cfg.iterations} "
              f"it, warm) backend={backend}: {solves[backend]:.3f} ms [{card}]", flush=True)
    for backend, kernel in (("pallas_fused", "iterate_fused"), ("pallas_full", "solve_full")):
        check(launches[backend][kernel] > 0, f"{backend}: kernel {kernel} never launched")

    kkt = admm_fast.setup(H, g, table, robot.fz_max, mpc, cfg, invert=False)
    ops = admm_fast.AdmmOperands(admm_fast.spd_inverse(kkt.K), *kkt[1:])
    P0 = admm_fast.cone_pattern(mpc.friction_coef, HORIZON)
    init = admm_fast.warm_init(kkt, P0, warm)
    srow, l, u = admm_fast.row_bounds(table, robot.fz_max, HORIZON)
    pairs = {
        "invert_spd": (lambda: admm_cuda.invert_spd(kkt.K, cfg.newton_schulz_iters),
                       lambda: admm_fast.spd_inverse(kkt.K, cfg.newton_schulz_iters),
                       lambda: torch.linalg.inv(kkt.K)),
        "iterate": (lambda: admm_cuda.iterate(ops, P0, cfg, init),
                    lambda: admm_fast.iterate_jnp(ops, P0, cfg, init), None),
        "iterate_fused": (lambda: admm_cuda.iterate_fused(kkt, P0, cfg, init),
                          lambda: admm_fast.iterate_jnp(
                              ops._replace(Kinv=admm_fast.spd_inverse(kkt.K)), P0, cfg, init),
                          None),
        "solve_full": (lambda: admm_cuda.solve_full(H, g, srow, l, u, P0, cfg, warm),
                       lambda: admm_fast.solve_full(H, g, srow, l, u, P0, cfg, warm), None),
    }
    flops = condensed_flops(n, m, cfg.iterations, cfg.newton_schulz_iters, cfg.ruiz_iters)
    nbytes = condensed_bytes(n, m)
    times = {}
    for name, (kernel, plain, library) in pairs.items():
        # In turns: plain, kernel, kernel, plain (the second of each is kept).
        cuda_ms(plain, reps=3)
        cuda_ms(kernel, reps=3)
        t_kernel = cuda_ms(kernel)
        t_plain = cuda_ms(plain, reps=5)
        t_lib = cuda_ms(library) if library else None
        bound, by = bound_ms(B * flops[name], B * nbytes[name])
        times[name] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib, bound_ms=bound,
                           bound_by=by)
        lib = f", torch.linalg.inv {t_lib:.3f} ms" if t_lib else ""
        print(f"phase 7: kernel {name} alone at B={B}, h={HORIZON}: {t_kernel:.3f} ms, plain "
              f"{t_plain:.3f} ms{lib}; bound {bound:.3f} ms ({by}) [{card}]", flush=True)
    # The invert kernel's recursion alone: no Newton-Schulz step.
    t_ns0 = cuda_ms(lambda: admm_cuda.invert_spd(kkt.K, 0))
    times["invert_spd"]["ns0_ms"] = t_ns0
    print(f"phase 7: kernel invert_spd alone at B={B}, h={HORIZON}, ns_iters=0 (the Schur "
          f"recursion): {t_ns0:.3f} ms, ns_iters={cfg.newton_schulz_iters}: "
          f"{times['invert_spd']['ms']:.3f} ms [{card}]", flush=True)
    ms_period = time_period(loop_state, "admm_fast")
    print(f"phase 7: one {PERIOD}-tick control period (1 solve tick) at B={B}, "
          f"solver=admm_fast: {ms_period:.3f} ms against the 20 ms real-time budget [{card}]",
          flush=True)
    return times, launches


def entry_report(log: str, kernel: str) -> str:
    """ptxas's register and spill lines for one kernel's entry function,
    and the largest spill store of any function in the library (the
    kernel's out-of-line callees are shared by every kernel of it)."""
    lines = log.splitlines()
    mine, inside = [], False
    for line in lines:
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("Used" in line or "spill" in line):
            mine.append(line.split(":", 1)[1].strip() if "Used" in line else line.strip())
    spills = [int(w[0]) for line in lines if "spill stores" in line
              for w in [line.split("bytes spill stores")[0].split(",")[-1].split()]]
    return f"{'; '.join(mine)}; largest spill store in the library {max(spills, default=0)} B"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = _build.load_all()
    here = os.path.dirname(os.path.abspath(__file__))
    print(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}); {len(libs)} kernel libraries built in parallel in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, lib in libs.items():
        ptxas = [l.split(":", 1)[1].strip() if "Used" in l else l.strip()
                 for l in lib.log.splitlines() if "Used" in l or "spill" in l]
        print(f"phase 1: {name}: nvcc {lib.build_seconds:.1f} s into "
              f"{os.path.relpath(lib.path, here)}; ptxas: {'; '.join(ptxas)}", flush=True)
    occ = riccati_cuda.occupancy(libs["riccati_admm"].lib, HORIZON)
    print(f"phase 1: riccati_admm at h={HORIZON}: {occ['scenarios_per_sm']} scenarios resident "
          f"per SM, {occ['scenarios_per_block']} per block, {occ['smem_per_block']} B of "
          f"dynamic shared memory per block", flush=True)
    occ = admm_cuda.invert_occupancy(libs["admm"].lib, 12 * HORIZON)
    print(f"phase 1: admm_invert_kernel at h={HORIZON}: {occ['blocks_per_sm']} blocks (scenarios) "
          f"resident per SM, {occ['smem_per_block']} B of dynamic shared memory per block, "
          f"{libs['admm'].lib.admm_workspace_floats(0, 12 * HORIZON, 0)} workspace floats per "
          f"scenario; ptxas: {entry_report(libs['admm'].log, 'admm_invert_kernel')}", flush=True)
    n = 12 * HORIZON
    cfg = admm_cuda.iterate_config(libs["admm_iterate"].lib, B_MAIN, n, 5 * n // 3)
    ptxas = entry_report(libs["admm_iterate"].log, "admm_iterate_kernel")
    print(f"phase 1: admm_iterate_kernel at h={HORIZON}, B={B_MAIN}: {cfg['threads']} threads a "
          f"block, {cfg['grid']} persistent blocks ({cfg['blocks_per_sm']} resident per SM), "
          f"{cfg['smem_per_block']} B of dynamic shared memory per block; ptxas: {ptxas}",
          flush=True)
    check(" 0 bytes spill stores, 0 bytes spill loads" in ptxas.split(";")[0],
          "admm_iterate_kernel: Kinv does not stay in registers (ptxas reports spills)")

    max_err = phase_kernel_vs_plain(dev)
    ric_launches, loop_state = phase_closed_loop(dev, "riccati", 3)
    ric_times = phase_times(dev, card, loop_state)
    del loop_state
    cond_err = phase_condensed_vs_plain(dev)
    cond_launches, loop_state = phase_closed_loop(dev, "admm_fast", 6)
    cond_times, backend_launches = phase_condensed_times(dev, card, loop_state)

    kernels = [{
        "name": "riccati_admm", "route": "cuda",
        "source": "pympc_quadruped_tpu_torch/csrc/riccati_admm.cu",
        "replaces": "pympc_quadruped_tpu/ops/qp/riccati_pallas.py:116",
        "launches": ric_launches["riccati_admm"], "max_abs_err": max_err,
        "err": "max|dU| [N] vs plain", **ric_times, "library_ms": None,
    }]
    replaces = {"invert_spd": 242, "iterate": 38, "iterate_fused": 374, "solve_full": 417}
    errs = {"invert_spd": "f64 residual ratio kernel/plain (bar 2)",
            "iterate": "max f64 relative cost excess over jnp (p99 bar 2e-5, max 1e-4)",
            "iterate_fused": "max f64 relative cost excess over jnp (p99 bar 2e-5, max 1e-4)",
            "solve_full": "max f64 relative cost excess over jnp (p99 bar 2e-5, max 1e-4)"}
    for name in ("invert_spd", "iterate", "iterate_fused", "solve_full"):
        on_loop = name in ("invert_spd", "iterate")
        launches = (cond_launches[name] if on_loop else
                    backend_launches["pallas_fused" if name == "iterate_fused"
                                     else "pallas_full"][name])
        source = "admm_iterate.cu" if name == "iterate" else "admm.cu"
        kernels.append({
            "name": name, "route": "cuda", "source": f"pympc_quadruped_tpu_torch/csrc/{source}",
            "replaces": f"pympc_quadruped_tpu/ops/qp/admm_pallas.py:{replaces[name]}",
            "launches": launches,
            "launches_in": ("admm_fast closed loop, 150 solves" if on_loop else
                            "timed solve_batch runs of its backend"),
            "max_abs_err": cond_err[name], "err": errs[name], **cond_times[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
