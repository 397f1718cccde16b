"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each or more; any failure exits non-zero and prints no
result):

1. device and build: a CUDA card, its name and power limit, every kernel
   built from ``pympc_quadruped_tpu_torch/csrc`` (one nvcc per source, in
   parallel) with its ptxas report, the Riccati and invert kernels'
   resident scenarios per SM and shared memory per block, the iterate
   kernel's launch at B=4096 (threads, persistent blocks, shared memory)
   and the fused and full kernels' (threads, resident blocks, shared
   memory, workspace floats), each with its entry's ptxas line, which must
   show no spills for the iterate kernel;
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
   port's ``build_qp`` at h=16 (B=4096 and B=130) and at phase 11b's h=10
   (B=4096), cold and warm-started:
   the invert kernel's f64 residual max|Kinv K - I| within 2x of the plain
   ``spd_inverse``'s; the fused kernel's scaled (x, y) bit for bit the
   split path's (invert, then iterate) on the same operands; and the
   ``pallas``, ``pallas_split``,
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
   its Newton-Schulz step, one 20-tick period;
8. ``srb_env.rollout``, the port's closed-loop entry point, on phase 3's
   scenarios with each solver: its non-solve ticks replay one captured CUDA
   graph.  The first 100 ticks must equal eager ``run_ticks`` bit for bit
   (any leaf that differs is named, and must stay within 1e-6 relative);
   3000 ticks must keep >= 99% in phase 3's band with one launch of each
   of the solver's kernels per solve tick (150).  Then, from tick 3000: the
   20-tick period against the 20 ms limit, the eager solve tick and one
   replayed non-solve tick (CUDA events, medians of 10 periods), the
   graph's kernel and copy nodes, and the device's busy share over two
   periods (``torch.profiler``: kernel time over the periods' time);
9. the estimator ``rollout`` as the JAX bench runs it (bench.py:914-960):
   A1, h=10, TROTTING10 at 0.8 m/s, ``KfParams.default()``,
   ``SensorNoise.default()``, ``cmd_ramp_ticks=300``, the default solver,
   B=4096, 2000 ticks, no auto-reset: >= 99% survive (height above 0.1 m,
   upright above 0.6 over the last quarter, never diverged), the
   estimator's position and velocity errors p50/p99 over the last three
   quarters, and their means over ticks 400-599 (the last 200 of
   tests/test_kf.py's 600-tick run) within tests/test_kf.py:286-287 (0.1 m,
   0.25 m/s); over the last 200 ticks the velocity error is held to 0.25
   m/s and the position error, whose x/y the filter cannot observe and
   which random-walks (tests/test_kf.py:247-250), is printed;
10. ``sweep.gait_sweep`` at B=4096 over trotting10 / pacing10 / bounding8,
   h=10, 3000 ticks, held to tests/test_gait_sweep.py:34-48: survival 1.0,
   tail velocity error below 0.3 m/s, forward displacement above 60% of
   the command's;
11. ``fullorder.rollout``, the torque-driven full-order environment (CRBA,
   RNEA, penalty contact, an 18x18 Cholesky a step), its non-solve ticks
   replayed from one captured CUDA graph: 11a Aliengo, h=16, TROTTING16 at
   1.0 m/s, ``riccati``; 11b Aliengo, h=10, TROTTING10 at 1.2 m/s, the
   default ``admm_fast`` (bench.py:757's configuration); both at B=4096
   scenarios jittered as tests/test_rbd.py:35-65 does, 1500 ticks.  The
   first 100 ticks must equal the same tick run eagerly bit for bit, each
   solver kernel must launch once per solve tick (75), and the in-band
   share (tests/test_h16_config.py:99-126, tests/test_rbd.py:400-425) must
   reach min(0.99, the JAX package's share on the same scenarios - 0.01);
   then the period, the eager solve tick, one replayed tick, the graph's
   nodes and ticks/s.  11c, every other captured branch at B=1024: the
   Kalman filter on noisy sensors with measured contact, 2 cm rough
   terrain, ``substeps=2``, ``auto_reset`` and a 400-tick command ramp:
   graph against eager bit for bit, then 1500 ticks finite with no
   scenario diverged;
12. the parity solvers (library calls and PyTorch ops, no hand kernel):
   12a, phase 3's scenarios at their first solve tick (B=4096, h=16)
   through ``engine.solve_scenarios`` with ``"admm_ref"`` and ``"ipm"``
   and through the parity pipeline (``build_qp_ff`` + ``ipm.solve_batch``
   with ``PARITY_CONFIG`` and the low words), against a yardstick, the
   fast path cold (YARDSTICK) whose (U, lam) must pass the f64 KKT gate on
   the card: every route finite, swing forces exactly 0, cone rows within
   1e-3 fz_max, and its f64 cost excess over the best feasible route at
   most 1e-4 of the cost scale at p99 (5x for the worst); the parity
   route's first-step GRFs within 1e-3 (the BASELINE bar), for the worst
   scenario, of the same call on the CPU over the first 256 scenarios and
   of the same scenarios solved on the card in batches of 256 over all
   4096; each route's time (``profiling.stage_timings``) against the 20 ms
   budget.
   12b, the golden lockstep (``step_batch(solver="ipm_parity")``, h=10,
   B=1, tests/test_golden_lockstep.py's 200 ticks) on the card against
   the CPU.  12c, ``srb_env.rollout`` with ``"admm"`` and ``"ipm"`` on phase
   3's scenarios, 1000 ticks (cut from 3000): finite, none diverged, >=
   99% in the band over the last 250 ticks (tests/test_h16_config.py:61-69
   without the displacement term); the period and the eager solve tick.

The last lines are the kernel summary and the device record.  Imports
torch, numpy and the port only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pympc_quadruped_tpu_torch import _build, engine, tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.control import refmpc
from pympc_quadruped_tpu_torch.env import fullorder, srb_env, terrain
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.loop import run_ticks
from pympc_quadruped_tpu_torch.models import Command, Gaits, a1, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.parallel import sweep
from pympc_quadruped_tpu_torch.ops import condense, lie, srb
from pympc_quadruped_tpu_torch.ops.kin import RobotObs
from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, admm_fast, cones, ipm, riccati, riccati_cuda
from pympc_quadruped_tpu_torch.utils import observability, profiling

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


def kernel_launches() -> dict:
    return {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}


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
    launches = kernel_launches()
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
    # h=16 is the condensed and SRB loops' horizon; h=10 (n=120, whose Schur
    # recursion splits 120 -> 60 -> 30 -> 15) is phase 11b's.
    for h, B in ((HORIZON, B_MAIN), (HORIZON, B_RAGGED), (10, B_MAIN)):
        p = condensed_problem(B, 11, dev, h=h)
        args = (p.H, p.g, p.table, p.robot.fz_max, p.mpc)
        K = admm_fast.setup(*args, admm_fast.AdmmFastConfig(), invert=False).K
        Kinv_k = admm_cuda.invert_spd(K)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(Kinv_k).all()), f"h={h} B={B}: non-finite invert_spd output")
        r_k = float(inverse_residual(Kinv_k, K).max())
        r_p = float(inverse_residual(admm_fast.spd_inverse(K), K).max())
        worst["invert_spd"] = max(worst["invert_spd"], r_k / r_p)
        print(f"phase 5: h={h} B={B} invert_spd: f64 max|Kinv K - I| kernel {r_k:.3e}, plain "
              f"{r_p:.3e} (ratio {r_k / r_p:.3f}, bar {INV_RATIO_BAR})", flush=True)
        check(r_k <= INV_RATIO_BAR * r_p, f"h={h} B={B}: invert_spd residual above the bar")
        for case, w, cfg in (("cold", None, admm_fast.AdmmFastConfig()),
                             ("warm", p.warm, admm_fast.AdmmFastConfig.inloop())):
            # The fused kernel runs the invert kernel's inverse and the
            # iterate kernel's summation order: its (x, y) are the split's.
            kkt = admm_fast.setup(*args, cfg, invert=False)
            P0 = admm_fast.cone_pattern(p.mpc.friction_coef, h)
            init = None if w is None else admm_fast.warm_init(kkt, P0, w)
            fused = admm_cuda.iterate_fused(kkt, P0, cfg, init)
            split = admm_cuda.invert_iterate(kkt, P0, cfg, init)
            torch.cuda.synchronize()
            differ = [int((a != b).sum()) for a, b in zip(fused, split)]
            print(f"phase 5: h={h} B={B} {case} iterate_fused against invert_spd + iterate: "
                  f"{differ[0]} of x and {differ[1]} of y differ (bar: bitwise equal)", flush=True)
            check(all(torch.equal(a, b) for a, b in zip(fused, split)),
                  f"h={h} B={B} {case}: the fused kernel differs from the split path")
            U_p = admm_fast.solve_batch(*args, cfg, backend="jnp", warm=w)
            cone_p = p99_max(qp_invariants(p, U_p, U_p)["cone"])
            fz_max = float(p.robot.fz_max.max())
            for backend, kernel in backend_kernel.items():
                U_k = admm_fast.solve_batch(*args, cfg, backend=backend, warm=w)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(U_k).all()),
                      f"h={h} B={B} {backend}: non-finite output")
                inv = qp_invariants(p, U_k, U_p)
                pm = {k: p99_max(v) for k, v in inv.items()}
                worst[kernel] = max(worst[kernel], pm["excess"][1])
                print(f"phase 5: h={h} B={B} {case} {backend} (p99 / max): cost excess "
                      f"{pm['excess'][0]:.3e} / {pm['excess'][1]:.3e} (bar {COST_BAR}), cone "
                      f"violation {pm['cone'][0]:.3e} / {pm['cone'][1]:.3e} N (bar "
                      f"{CONE_SHARE * fz_max:g}; plain {cone_p[0]:.3e} / {cone_p[1]:.3e}), "
                      f"predicted CoM {pm['pos'][0]:.2e} / {pm['pos'][1]:.2e} m, "
                      f"{pm['vel'][0]:.2e} / {pm['vel'][1]:.2e} m/s (bars {TRAJ_POS_BAR}, "
                      f"{TRAJ_VEL_BAR}; max {WORST_FACTOR:g}x); diagnostics: |cost diff| "
                      f"{pm['cost'][1]:.3e}, first-step fz rel {pm['fz'][0]:.3e} / "
                      f"{pm['fz'][1]:.3e}", flush=True)
                check(invariants_ok(inv, fz_max),
                      f"h={h} B={B} {case} {backend}: kernel disagrees with the plain version")
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


# ---------------------------------------------------------------------------
# The rollout, its estimator mode and the gait sweep
# ---------------------------------------------------------------------------

def bitwise_report(got, want, rel_bar=1e-6):
    """Leaves of two trees that are not bit for bit equal: {name: max
    relative difference}; fails if one exceeds ``rel_bar``."""
    diffs = {}

    def walk(a, b, name):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                walk(getattr(a, f.name), getattr(b, f.name), f"{name}.{f.name}")
        elif isinstance(a, tuple):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{name}[{i}]")
        elif not torch.equal(a, b):
            x, y = a.double(), b.double()
            diffs[name] = float(((x - y).abs() / y.abs().clamp(min=1e-30)).max())
    walk(got, want, "")
    for name, rel in diffs.items():
        check(rel <= rel_bar, f"rollout leaf {name} differs from eager by {rel:.3e} relative")
    return diffs


def graph_nodes(graph) -> dict:
    """Node counts by type of a captured graph (``keep_graph=True``), read
    through libcuda (cuGraphGetNodes): node type 0 kernel, 1 memcpy, 2 memset."""
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    names = {0: "kernel", 1: "memcpy", 2: "memset"}
    counts = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        key = names.get(t.value, f"type{t.value}")
        counts[key] = counts.get(key, 0) + 1
    return counts


def time_rollout_periods(loop, periods=10):
    """Medians over ``periods`` 20-tick periods of ``loop`` (which must
    start on a solve tick): the period, its eager solve tick, and one
    replayed non-solve tick, in ms by CUDA events."""
    rows = []
    for _ in range(periods):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        loop.step()
        e[1].record()
        for _ in range(PERIOD - 1):
            loop.step()
        e[2].record()
        torch.cuda.synchronize()
        rows.append((e[0].elapsed_time(e[2]), e[0].elapsed_time(e[1]),
                     e[1].elapsed_time(e[2]) / (PERIOD - 1)))
    return [float(v) for v in np.median(np.array(rows), axis=0)]


def busy_share(loop, periods=2) -> float:
    """Kernel time on the card over the time of ``periods`` periods, both
    from ``torch.profiler`` and CUDA events over the same window."""
    from torch.profiler import ProfilerActivity, profile

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0.record()
        for _ in range(periods * PERIOD):
            loop.step()
        e1.record()
        torch.cuda.synchronize()
    kernel_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
    check(kernel_us > 0, "the profiler recorded no time on the card")
    return kernel_us / 1e3 / e0.elapsed_time(e1)


def phase_rollout(dev, card, solver):
    """Phase 8 for one solver; returns the launch counts of the 3000-tick
    rollout and the timing record."""
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(dev)
    B = B_MAIN
    carry_e, state_e, _ = run_ticks(robot, mpc, gait, cmd, carry, state, 0, 100, solver)
    (state_g, carry_g), _ = srb_env.rollout(robot, mpc, gait, cmd, 100, init_state=state,
                                            solver=solver)
    torch.cuda.synchronize()
    diffs = bitwise_report((state_g, carry_g), (state_e, carry_e))
    print(f"phase 8: rollout solver={solver} B={B}: first 100 ticks against eager run_ticks: "
          + ("bitwise equal" if not diffs else f"differ in {diffs} (bar 1e-6 relative)"),
          flush=True)

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    (state_f, carry_f), m = srb_env.rollout(robot, mpc, gait, cmd, N_TICKS, init_state=state,
                                            solver=solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    n_solves = N_TICKS // PERIOD
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate")
    for name, count in launches.items():
        check(count == (n_solves if name in on_path else 0),
              f"rollout {solver}: kernel {name} launched {count} times, expected "
              f"{n_solves if name in on_path else 0}")
    check(all(tuple(v.shape) == (N_TICKS, B) for v in m.values()), "rollout metric shapes")
    vel_err = m["vel_err"][-BAND_TICKS:].mean(dim=0)
    height, x = state_f.pos[:, 2], state_f.pos[:, 0]
    ok = ((~m["diverged"].any(dim=0)) & (vel_err < 0.15) & (height > 0.34) & (height < 0.42)
          & (x > 2.0))
    share = float(ok.float().mean())
    counts = ", ".join(f"{k} {launches[k]}" for k in on_path)
    print(f"phase 8: rollout solver={solver} B={B} h={HORIZON} {N_TICKS} ticks in {wall:.1f} s "
          f"(capture included): {int(ok.sum())}/{B} in band ({share:.4f}, bar {BAND_SHARE}); "
          f"kernel launches {counts}; median vel_err {float(vel_err.median()):.4f} m/s, median "
          f"final height {float(height.median()):.4f} m, median x {float(x.median()):.3f} m",
          flush=True)
    check(share >= BAND_SHARE, f"rollout {solver}: only {share:.4f} of scenarios in the band")

    t0 = time.perf_counter()
    loop = srb_env.RolloutLoop(robot, mpc, gait, cmd, PERIOD * 14, init_state=state_f,
                               carry_in=carry_f, tick0=N_TICKS, solver=solver)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    nodes = graph_nodes(loop.graph)
    for _ in range(2 * PERIOD):
        loop.step()
    period, solve_tick, replay_tick = time_rollout_periods(loop)
    busy = busy_share(loop)
    print(f"phase 8: rollout solver={solver} B={B}: one {PERIOD}-tick period {period:.3f} ms "
          f"against the 20 ms real-time limit; eager solve tick {solve_tick:.3f} ms, replayed "
          f"non-solve tick {replay_tick:.3f} ms; graph of the non-solve tick: {nodes} nodes, "
          f"captured in {capture_s:.2f} s (setup included); device busy {busy:.3f} of two "
          f"periods (profiler on) [{card}]", flush=True)
    return launches, dict(period_ms=period, solve_tick_ms=solve_tick, replay_tick_ms=replay_tick,
                          graph_nodes=nodes, busy_share=busy)


def phase_estimator(dev, card):
    """Phase 9: bench.py:914-960's estimator loop at B=4096."""
    B, ticks = B_MAIN, 2000
    mpc = default_mpc_params(10, device=dev)
    robot = tree.tile(a1(device=dev), B)
    gait = tree.tile(Gaits.trotting10(device=dev), B)
    cmd = tree.tile(Command.trot_forward(0.8, device=dev), B)
    reset_launches()
    t0 = time.perf_counter()
    (state, _), m = srb_env.rollout(
        robot, mpc, gait, cmd, ticks, auto_reset=False, estimator=kf.KfParams.default(device=dev),
        sensor_noise=srb_env.SensorNoise.default(dev), key=1, cmd_ramp_ticks=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    check(launches["invert_spd"] == ticks // PERIOD and launches["iterate"] == ticks // PERIOD,
          f"estimator rollout: kernel launches {launches}")
    alive = ((state.pos[:, 2] > 0.1) & (m["upright"][-ticks // 4:].amin(dim=0) > 0.6)
             & ~m["diverged"].any(dim=0))
    survival = float(alive.float().mean())
    ep, ev = m["est_pos_err"][ticks // 4:], m["est_vel_err"][ticks // 4:]
    q = torch.tensor([0.5, 0.99], device=dev)
    ep_q = torch.quantile(ep.flatten(), q).tolist()
    ev_q = torch.quantile(ev.flatten(), q).tolist()
    # tests/test_kf.py holds a 600-tick run's last 200 ticks to its bars; here
    # the same window, ticks 400-599.  Absolute x/y is unobservable, so the
    # position estimate random-walks on: the last 200 of 2000 ticks are
    # printed, and only the velocity error is held there.
    pos_600, vel_600 = float(m["est_pos_err"][400:600].mean()), float(m["est_vel_err"][400:600].mean())
    pos_tail, vel_tail = float(m["est_pos_err"][-200:].mean()), float(m["est_vel_err"][-200:].mean())
    print(f"phase 9: estimator rollout A1 h=10 trotting10 0.8 m/s, KF + default sensor noise, "
          f"ramp 300, B={B}, {ticks} ticks in {wall:.1f} s: survival {survival:.4f} (bar "
          f"{BAND_SHARE}); est_pos_err p50 {ep_q[0]:.4f} / p99 {ep_q[1]:.4f} m, est_vel_err p50 "
          f"{ev_q[0]:.4f} / p99 {ev_q[1]:.4f} m/s (ticks {ticks // 4}-{ticks}); "
          f"means over ticks 400-599 {pos_600:.4f} m (bar 0.1), {vel_600:.4f} m/s (bar 0.25), "
          f"over the last 200 ticks {pos_tail:.4f} m, {vel_tail:.4f} m/s (bar 0.25); "
          f"kernel launches invert_spd {launches['invert_spd']}, iterate "
          f"{launches['iterate']} [{card}]", flush=True)
    check(survival >= BAND_SHARE, f"estimator rollout: survival {survival:.4f}")
    check(pos_600 < 0.1 and vel_600 < 0.25 and vel_tail < 0.25,
          "estimator rollout: estimate errors above the bars")


def phase_gait_sweep(dev, card):
    """Phase 10: the mixed-gait sweep at B=4096."""
    names, ticks = ["trotting10", "pacing10", "bounding8"], 3000
    robot_b = tree.tile(aliengo(device=dev), B_MAIN)
    t0 = time.perf_counter()
    _, per_gait = sweep.gait_sweep(robot_b, default_mpc_params(10, device=dev), names, ticks)
    wall = time.perf_counter() - t0
    for name in names:
        s = per_gait[name]
        expect = sweep.GAIT_SWEEP_VX[name] * ticks * 1e-3
        print(f"phase 10: gait_sweep B={B_MAIN} h=10 {ticks} ticks ({wall:.1f} s) {name}: "
              f"survival {s['survival_frac']:.4f} (bar 1.0), mean_vel_err "
              f"{s['mean_vel_err']:.4f} m/s (bar 0.3), fwd_disp {s['fwd_disp_m']:.3f} m (bar "
              f"{0.6 * expect:.2f}) [{card}]", flush=True)
        check(s["survival_frac"] == 1.0 and s["mean_vel_err"] < 0.3
              and s["fwd_disp_m"] > 0.6 * expect, f"gait_sweep {name}: outside the bars")


# ---------------------------------------------------------------------------
# The full-order environment
# ---------------------------------------------------------------------------

FO_TICKS, FO_TAIL, FO_BITWISE_TICKS = 1500, 500, 100
#: The JAX package's in-band share on the same 4096 scenarios, run on a CPU
#: by tools/fullorder_reference_share.py; its output lines are kept in
#: tools/fullorder_reference_share.jsonl (PERF.md section 6).  The port
#: must reach min(BAND_SHARE, share - 0.01).
FO_REFERENCE_SHARE = {"11a": 4072 / 4096, "11b": 3535 / 4096}
#: Phase 11's trots (Aliengo): horizon, gait, command, solver, the seed of
#: the jitter, and the band (height low and high, vel_err, upright, final
#: x) over the last FO_TAIL ticks: tests/test_h16_config.py:99-126 for 11a,
#: tests/test_rbd.py:400-425 (bench.py:757's configuration) for 11b.
FO_PARTS = {
    "11a": dict(horizon=16, gait="trotting16", vx=1.0, solver="riccati", seed=13,
                band=(0.33, 0.42, 0.2, 0.9, 0.8)),
    "11b": dict(horizon=10, gait="trotting10", vx=1.2, solver="admm_fast", seed=27,
                band=(0.33, 0.42, 0.15, 0.9, 1.0)),
}


def fullorder_jitter(B: int, seed: int):
    """tests/test_rbd.py:35-65's jitter of the nominal stance, made with
    numpy: (dpos (B,3), dq (B,12), du (B,18)) float32, scenario 0 nominal,
    +-1 cm base xy, +-3 mm base z, +-0.01 rad joints, +-0.02 on every
    generalized velocity."""
    rng = np.random.default_rng(seed)
    dpos = np.zeros((B, 3), np.float32)
    dpos[1:, :2] = rng.uniform(-0.01, 0.01, (B - 1, 2))
    dpos[1:, 2] = rng.uniform(-0.003, 0.003, B - 1)
    dq = np.zeros((B, 12), np.float32)
    dq[1:] = rng.uniform(-0.01, 0.01, (B - 1, 12))
    du = np.zeros((B, 18), np.float32)
    du[1:] = rng.uniform(-0.02, 0.02, (B - 1, 18))
    return dpos, dq, du


def fullorder_in_band(metrics: dict, x: torch.Tensor, band) -> torch.Tensor:
    """(B,) bool: finite height on every tick, and over the last FO_TAIL
    ticks the mean height inside (lo, hi), the mean vel_err below its bar
    and the least upright above its bar; the final base x above its bar."""
    lo, hi, v_bar, up_bar, x_bar = band
    height = metrics["height"]
    h = height[-FO_TAIL:].mean(dim=0)
    v = metrics["vel_err"][-FO_TAIL:].mean(dim=0)
    up = metrics["upright"][-FO_TAIL:].amin(dim=0)
    return (torch.isfinite(height).all(dim=0) & (h > lo) & (h < hi) & (v < v_bar)
            & (up > up_bar) & (x > x_bar))


FO_LAUNCHES_IN = {
    "riccati": f"fullorder.rollout(solver='riccati'), h=16, {FO_TICKS} ticks, "
               f"{FO_TICKS // PERIOD} solves (phase 11a)",
    "admm_fast": f"fullorder.rollout(solver='admm_fast'), h=10, {FO_TICKS} ticks, "
                 f"{FO_TICKS // PERIOD} solves (phase 11b)",
}


def fullorder_setup(dev, part: str, B: int):
    """Phase 11a/11b's batch: Aliengo, the part's horizon, gait and command,
    and the jittered nominal stance (the first ``B`` of B_MAIN draws)."""
    p = FO_PARTS[part]
    mpc = default_mpc_params(p["horizon"], device=dev)
    robot = tree.tile(aliengo(device=dev), B)
    gait = tree.tile(Gaits.by_name(p["gait"], device=dev), B)
    cmd = tree.tile(Command.trot_forward(p["vx"], device=dev), B)
    state = fullorder.default_init_state(robot)
    dpos, dq, du = (torch.tensor(a[:B], device=dev) for a in fullorder_jitter(B_MAIN, p["seed"]))
    state = dataclasses.replace(state, pos=state.pos + dpos, q=state.q + dq, u=state.u + du)
    return mpc, robot, gait, cmd, state


def fullorder_graph_and_eager(args, n_ticks, **kwargs):
    """``fullorder.rollout`` over ``n_ticks`` (the non-solve ticks replayed
    from its graph) and the same loop's tick run eagerly on every tick:
    both ((state, full carry), metrics)."""
    graph = fullorder.rollout(*args, n_ticks, return_full_carry=True, **kwargs)
    eager = fullorder.RolloutLoop(*args, n_ticks, **kwargs)
    for tick in range(eager.tick0, eager.tick0 + n_ticks):
        eager._tick(eager.buf, solve=ctrl.is_solve_tick(args[1], tick))
    return graph, eager.result(return_full_carry=True)


def fullorder_graph_vs_eager(phase, args, kwargs):
    """The first FO_BITWISE_TICKS ticks of the graph against the eager tick:
    state, full carry and metrics bit for bit."""
    ((s_g, c_g), m_g), ((s_e, c_e), m_e) = fullorder_graph_and_eager(
        args, FO_BITWISE_TICKS, **kwargs)
    torch.cuda.synchronize()
    diffs = bitwise_report((s_g, c_g, tuple(m_g.values())), (s_e, c_e, tuple(m_e.values())))
    print(f"phase {phase}: first {FO_BITWISE_TICKS} ticks replayed against the same tick run "
          f"eagerly: " + ("bitwise equal" if not diffs else f"differ in {diffs}"), flush=True)
    check(not diffs, f"phase {phase}: the graph's ticks differ from the eager ticks")


def phase_fullorder_trot(dev, card, part: str):
    """Phase 11a or 11b at B=4096: graph against eager, FO_TICKS ticks held
    to the band and to one launch of each solver kernel per solve tick,
    then the period, its eager solve tick and one replayed tick."""
    p = FO_PARTS[part]
    B, solver = B_MAIN, p["solver"]
    mpc, robot, gait, cmd, state0 = fullorder_setup(dev, part, B)
    args = (robot, mpc, gait, cmd)
    fullorder_graph_vs_eager(part, args, dict(state0=state0, solver=solver))

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    (state, carry), m = fullorder.rollout(*args, FO_TICKS, state0=state0, solver=solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    n_solves = FO_TICKS // PERIOD
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate")
    for name, count in launches.items():
        check(count == (n_solves if name in on_path else 0),
              f"phase {part}: kernel {name} launched {count} times, expected "
              f"{n_solves if name in on_path else 0}")
    check(all(tuple(v.shape) == (FO_TICKS, B) for v in m.values()), "fullorder metric shapes")
    ok = fullorder_in_band(m, state.pos[:, 0], p["band"])
    share = float(ok.float().mean())
    bar = min(BAND_SHARE, FO_REFERENCE_SHARE[part] - 0.01)
    counts = ", ".join(f"{k} {launches[k]}" for k in on_path)
    print(f"phase {part}: fullorder.rollout Aliengo h={p['horizon']} {p['gait']} {p['vx']} m/s "
          f"solver={solver} B={B}, {FO_TICKS} ticks in {wall:.1f} s (capture included): "
          f"{int(ok.sum())}/{B} in band ({share:.4f}; bar {bar:.4f} = min({BAND_SHARE}, JAX "
          f"{FO_REFERENCE_SHARE[part]:.4f} - 0.01)); kernel launches {counts}; diverged "
          f"{int(m['diverged'].any(dim=0).sum())}; median final x "
          f"{float(state.pos[:, 0].median()):.3f} m", flush=True)
    check(share >= bar, f"phase {part}: only {share:.4f} of scenarios in the band")

    t0 = time.perf_counter()
    loop = fullorder.RolloutLoop(*args, PERIOD * 12, state0=state, carry0=carry, solver=solver,
                                 tick0=FO_TICKS)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    nodes = graph_nodes(loop.graph)
    for _ in range(2 * PERIOD):
        loop.step()
    period, solve_tick, replay_tick = time_rollout_periods(loop)
    print(f"phase {part}: fullorder solver={solver} B={B}: one {PERIOD}-tick period "
          f"{period:.3f} ms ({B * PERIOD / period * 1e3:.0f} ticks/s) against the 20 ms "
          f"real-time limit; eager solve tick {solve_tick:.3f} ms, replayed non-solve tick "
          f"{replay_tick:.3f} ms; graph of the non-solve tick: {nodes} nodes, captured in "
          f"{capture_s:.2f} s (setup included) [{card}]", flush=True)
    return launches, dict(period_ms=period, solve_tick_ms=solve_tick, replay_tick_ms=replay_tick,
                          ticks_per_s=B * PERIOD / period * 1e3, graph_nodes=nodes,
                          in_band=share, bar=bar, wall_s=wall)


def phase_fullorder_branches(dev, card):
    """Phase 11c: every other captured branch at B=1024: the Kalman filter
    on noisy sensors with measured contact, rough terrain, two physics
    substeps, auto-reset and a command ramp; graph against eager, then
    FO_TICKS ticks that stay finite with no scenario diverging."""
    B = 1024
    mpc = default_mpc_params(10, device=dev)
    robot = tree.tile(aliengo(device=dev), B)
    gait = tree.tile(Gaits.trotting10(device=dev), B)
    cmd = tree.tile(Command.trot_forward(0.8, device=dev), B)
    terr = tree.tile(terrain.random_rough(torch.Generator(device=dev).manual_seed(11),
                                          amplitude=0.02, device=dev), B)
    est = dataclasses.replace(kf.KfParams.default(device=dev),
                              contact_height=torch.tensor(0.0255, device=dev))
    kwargs = dict(terrain=terr, estimator=est, sensor_noise=srb_env.SensorNoise.default(dev),
                  key=5, substeps=2, auto_reset=True, cmd_ramp_ticks=400)
    args = (robot, mpc, gait, cmd)
    fullorder_graph_vs_eager("11c", args, kwargs)
    t0 = time.perf_counter()
    (state, _), m = fullorder.rollout(*args, FO_TICKS, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(t).all()) for t in (state.pos, state.quat, state.u, state.q))
    n_div = int(m["diverged"].any(dim=0).sum())
    up = float(m["upright"][-FO_TAIL:].amin())
    ev = float(m["est_vel_err"][-FO_TAIL:].mean())
    print(f"phase 11c: fullorder.rollout Aliengo h=10 trotting10 0.8 m/s, KF on default sensor "
          f"noise with measured contact, 2 cm rough terrain, substeps=2, auto_reset, ramp 400, "
          f"B={B}, {FO_TICKS} ticks in {wall:.1f} s (capture included): finite {finite}, "
          f"{n_div} scenarios diverged (bar 0); least upright over the last {FO_TAIL} ticks "
          f"{up:.3f}, mean est_vel_err {ev:.4f} m/s [{card}]", flush=True)
    check(finite and n_div == 0, "phase 11c: a scenario diverged or went non-finite")
    return dict(wall_s=wall, diverged=n_div)


# ---------------------------------------------------------------------------
# The parity solvers
# ---------------------------------------------------------------------------

#: Phase 12a's bar on the f64 cost excess over the best feasible route, as a
#: share of |cost| + 1, for the 99th percentile (the worst scenario gets
#: WORST_FACTOR times it): tests/test_torch_admm.py's h=16 bar.
PARITY_COST_BAR = 1e-4
#: The yardstick: admm_fast, cold, 320 iterations at the in-loop preset's
#: rho 1e-3 (at the cold preset's 5e-4 the certificate's stationarity stalls
#: near 1.4e-2 p99 on these problems whatever the iterations, above the
#: gate's 1e-2).  And the parity route's bar (the BASELINE GRF parity bar,
#: max |dU| / (1 + |U|) over the first-step GRFs, held by the worst
#: scenario) against the same call on the CPU, on the first CPU_B
#: scenarios, and against the same scenarios solved on the card in batches
#: of CPU_B, over all of them.
YARDSTICK = admm_fast.AdmmFastConfig(iterations=320, rho=admm_fast.AdmmFastConfig.inloop().rho)
PARITY_GRF_BAR, CPU_B = 1e-3, 256
#: Phase 12c: ticks (cut from phase 8's 3000) and the tail of the band.
CL_TICKS, CL_TAIL = 1000, 250


def engine_inputs(dev, B):
    """Phase 3's jittered scenarios (the first ``B``) at their first solve
    tick, as ``engine.solve_scenarios`` takes them: (mpc, robot, (x_t, yaw,
    feet, X_ref, table))."""
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(dev)
    obs = srb_env.observe(robot, state)
    ks, _, table, x_t, mpc_carry, vel = ctrl._pre_solve(robot, mpc, gait, cmd, carry, obs, 0)
    _, X = refmpc.reference_trajectory(mpc_carry, x_t, vel, cmd, mpc, robot, table)
    inputs = (x_t, x_t[:, 2], ks.pos_base_feet, X, table)
    return mpc, tree.tile(aliengo(device=dev), B), tuple(t[:B].contiguous() for t in inputs)


def parity_routes(mpc, robot, inputs) -> dict:
    """Phase 12a's routes, each a function returning the swing-masked
    full-horizon U (B,12h): the engine's ``admm_ref`` and ``ipm``, and the
    parity pipeline (``build_qp_ff`` + ``ipm.solve_batch`` with
    ``PARITY_CONFIG`` and the low words)."""
    def eng(solver):
        return lambda: engine.solve_scenarios(robot, mpc, *inputs, solver=solver,
                                              return_full_horizon=True)

    def parity():
        x_t, yaw, feet, X, table = inputs
        H, H_lo, g, g_lo, mv = refmpc.build_qp_ff(robot, mpc, x_t, yaw, feet, X, table)
        G, h_vec, _ = cones.block_constraints(table, robot.fz_max, mpc)
        return ipm.solve_batch(H, g, G, h_vec, ipm.PARITY_CONFIG, H_lo, g_lo) * mv

    return {"admm_ref": eng("admm_ref"), "ipm": eng("ipm"), "parity": parity}


def yardstick(mpc, robot, inputs):
    """The fast path, cold, with the YARDSTICK config and its duals."""
    return engine.solve_scenarios(robot, mpc, *inputs, solver="admm", return_full_horizon=True,
                                  return_duals=True, admm_fast_cfg=YARDSTICK)


def cone_violation(U, table, fz_max, mpc):
    """Per-scenario worst friction-pyramid row violation [N] of U, in f64."""
    P0 = admm_fast.cone_pattern(mpc.friction_coef, mpc.horizon).double()
    srow, l, u = admm_fast.row_bounds(table, fz_max, mpc.horizon)
    z = U.double() @ P0.T
    viol = torch.maximum(l - z, torch.where(torch.isfinite(u), z - u, torch.zeros_like(z)))
    return (viol * srow).clamp(min=0.0).amax(-1)


def f64_cost(H64, g64, U):
    """Per-scenario f64 cost 1/2 U^T H U + g^T U."""
    V = U.double()
    return 0.5 * (V[:, None] @ H64 @ V[..., None])[:, 0, 0] + (g64 * V).sum(-1)


def grf_deviation(U, U_ref):
    """max |U - U_ref| / (1 + |U_ref|) per scenario over the first-step GRFs
    (p99, max) and over the full horizon (max)."""
    rel = (U.double() - U_ref.double()).abs() / (1.0 + U_ref.double().abs())
    return (*p99_max(rel[:, :12].amax(-1)), float(rel.max()))


def phase_parity_engine(dev, card):
    """Phase 12a: the parity routes at B=4096, h=16, held to the QP's
    invariants against each other, the certified yardstick and the same
    calls on the CPU; then each route's time."""
    mpc, robot, inputs = engine_inputs(dev, B_MAIN)
    table, fz_max = inputs[4], float(robot.fz_max.max())
    routes = parity_routes(mpc, robot, inputs)
    U = {name: fn() for name, fn in routes.items()}
    U["yardstick"], lam = yardstick(mpc, robot, inputs)
    torch.cuda.synchronize()
    H, g, mv = refmpc.build_qp(robot, mpc, *inputs)
    res = observability.kkt_residuals_f64(H, g, table, robot.fz_max, U["yardstick"], lam, mpc)
    kkt_ok, kkt = observability.kkt_gate(res, robot.fz_max)
    print(f"phase 12a: yardstick admm_fast cold {YARDSTICK.iterations} it, rho {YARDSTICK.rho:g}, "
          f"at B={B_MAIN} h={HORIZON}: "
          f"f64 KKT certificate on the card {kkt} (gate {'passes' if kkt_ok else 'FAILS'})",
          flush=True)
    check(kkt_ok, "phase 12a: the yardstick fails the f64 KKT gate")

    # Every route's f64 cost on the float64-condensed problem (hi + lo words).
    H_hi, H_lo, g_hi, g_lo, _ = refmpc.build_qp_ff(robot, mpc, *inputs)
    H64, g64 = H_hi.double() + H_lo.double(), g_hi.double() + g_lo.double()
    cost = {k: f64_cost(H64, g64, V) for k, V in U.items()}
    cone = {k: cone_violation(V, table, robot.fz_max, mpc) for k, V in U.items()}
    feasible = {k: cone[k] <= CONE_SHARE * fz_max for k in U}
    best = torch.stack([torch.where(feasible[k], cost[k], torch.full_like(cost[k], float("inf")))
                        for k in U]).amin(0)
    check(bool(torch.isfinite(best).all()), "phase 12a: a scenario has no feasible route")
    for name, V in U.items():
        finite = bool(torch.isfinite(V).all())
        swing_zero = bool((V[mv == 0] == 0).all())
        excess = (cost[name] - best) / (best.abs() + 1.0)
        p99, worst = p99_max(excess)
        cone_max = float(cone[name].max())
        print(f"phase 12a: {name} at B={B_MAIN} h={HORIZON}: finite {finite}, swing forces "
              f"exactly 0 {swing_zero}, cone violation max {cone_max:.3e} N (bar "
              f"{CONE_SHARE * fz_max:g}), f64 cost excess over the best feasible route p99 "
              f"{p99:.3e} / max {worst:.3e} (bars {PARITY_COST_BAR:g} / "
              f"{WORST_FACTOR * PARITY_COST_BAR:g})", flush=True)
        check(finite and swing_zero and cone_max <= CONE_SHARE * fz_max
              and p99 <= PARITY_COST_BAR and worst <= WORST_FACTOR * PARITY_COST_BAR,
              f"phase 12a: route {name} outside the bars")

    # The same calls on the CPU, on the first CPU_B scenarios.
    cpu = torch.device("cpu")
    mpc_c, robot_c = tree.to(mpc, cpu), tree.tile(aliengo(device=cpu), CPU_B)
    inputs_c = tuple(t[:CPU_B].cpu() for t in inputs)
    U_cpu = {name: fn() for name, fn in parity_routes(mpc_c, robot_c, inputs_c).items()}
    first_p99, first_max, full_max = grf_deviation(U["parity"][:CPU_B].cpu(), U_cpu["parity"])
    diffs = {}
    for k in ("admm_ref", "ipm"):
        c = f64_cost(H64[:CPU_B].cpu(), g64[:CPU_B].cpu(), U_cpu[k])
        diffs[k] = float(((cost[k][:CPU_B].cpu() - c).abs() / (c.abs() + 1.0)).max())
    print(f"phase 12a: the first {CPU_B} scenarios run by the port on the CPU: parity first-step "
          f"GRFs |dU|/(1+|U|) p99 {first_p99:.3e} / max {first_max:.3e} (bar "
          f"{PARITY_GRF_BAR:g} for the max); full horizon max {full_max:.3e} "
          f"(printed, not gated); f32 routes' two-sided f64 cost difference card vs CPU "
          f"(printed, not gated): admm_ref {diffs['admm_ref']:.3e}, ipm {diffs['ipm']:.3e}",
          flush=True)
    check(first_max < PARITY_GRF_BAR,
          "phase 12a: the parity route on the card disagrees with the CPU")
    # The same scenarios on the card in batches of CPU_B: the answer must not
    # depend on the batch it was solved in.
    robot_b = tree.tile(aliengo(device=dev), CPU_B)
    U_chunks = torch.cat([parity_routes(mpc, robot_b, tuple(t[lo:lo + CPU_B] for t in inputs))
                          ["parity"]() for lo in range(0, B_MAIN, CPU_B)])
    b_p99, b_max, b_full = grf_deviation(U["parity"], U_chunks)
    print(f"phase 12a: parity on the card at B={B_MAIN} against the same scenarios in batches "
          f"of {CPU_B}: first-step GRFs p99 {b_p99:.3e} / max {b_max:.3e} (bar "
          f"{PARITY_GRF_BAR:g} for the max); full horizon max {b_full:.3e} (printed, not gated)",
          flush=True)
    check(b_max < PARITY_GRF_BAR,
          "phase 12a: the parity route on the card depends on the batch it is solved in")

    times = {}
    solves = dict(routes, yardstick=lambda: yardstick(mpc, robot, inputs))
    for name, fn in solves.items():
        t = profiling.stage_timings(lambda *_: fn(), *inputs, iters=5, warmup=1)
        times[name] = t
        print(f"phase 12a: {name} at B={B_MAIN} h={HORIZON}: p50 {t['p50_ms']:.3f} ms, p99 "
              f"{t['p99_ms']:.3f} ms against the {t['budget_ms']:g} ms budget (within: "
              f"{t['within_budget']}) [{card}]", flush=True)
    return {k: {"p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"]} for k, v in times.items()}


def golden_obs(tick: int):
    """The synthetic trot observations of tests/test_golden_lockstep.py:45-78
    at 1 kHz tick ``tick`` (a copy: this script imports nothing of tests/)."""
    t = tick * 0.001
    rpy = np.array([0.01 * np.sin(7.1 * t), 0.02 * np.sin(5.3 * t + 1.0),
                    0.03 * np.sin(2.9 * t)])
    cr, sr = np.cos(rpy[0] / 2), np.sin(rpy[0] / 2)
    cp, sp = np.cos(rpy[1] / 2), np.sin(rpy[1] / 2)
    cy, sy = np.cos(rpy[2] / 2), np.sin(rpy[2] / 2)
    quat = np.array([cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                     cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr])
    pos = np.array([1.1 * t, 0.02 * np.sin(3.0 * t), 0.38 + 0.008 * np.sin(9.0 * t)])
    vel = np.array([1.1 + 0.1 * np.sin(4.0 * t), 0.05 * np.cos(3.0 * t),
                    0.05 * np.sin(6.0 * t)])
    omega = np.array([0.1 * np.sin(8.0 * t), 0.15 * np.cos(6.0 * t), 0.05 * np.sin(3.0 * t)])
    q = np.tile([0.0, 0.8, -1.6], 4) + 0.15 * np.sin(11.0 * t + np.arange(12) * 0.7)
    qdot = 1.5 * np.cos(11.0 * t + np.arange(12) * 0.7)
    return {"pos_base": pos, "lin_vel_base": vel, "quat_base": quat, "ang_vel_base": omega,
            "q": q, "qdot": qdot}


def golden_run(dev, ticks=200):
    """``controller.step_batch(solver="ipm_parity")``, Aliengo, h=10,
    TROTTING10 at 1.2 m/s, B=1, over ``ticks`` ticks of golden_obs: the
    per-tick (forces, torques, swing states) as float64 numpy arrays."""
    mpc = default_mpc_params(10, device=dev)
    robot = tree.tile(aliengo(device=dev), 1)
    gait = tree.tile(Gaits.trotting10(device=dev), 1)
    cmd = tree.tile(Command.trot_forward(1.2, device=dev), 1)
    carry = tree.tile(ctrl.init_carry(10, device=dev), 1)
    rows = []
    for tick in range(ticks):
        obs = RobotObs(**{k: torch.tensor(np.float32(v)[None], device=dev)
                          for k, v in golden_obs(tick).items()})
        carry, out = ctrl.step_batch(robot, mpc, gait, cmd, carry, obs, tick,
                                     solver="ipm_parity")
        rows.append(tuple(t[0].double().cpu().numpy()
                          for t in (out.contact_forces, out.torques, out.swing_states)))
    return rows


def phase_golden(dev, card):
    """Phase 12b: the golden lockstep's 200 ticks on the card against the
    same ticks run by the port on the CPU."""
    t0 = time.perf_counter()
    gpu = golden_run(dev)
    wall = time.perf_counter() - t0
    cpu = golden_run(torch.device("cpu"))
    rel = lambda a, b: float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
    grf = max(rel(gpu[t][0], cpu[t][0]) for t in range(0, len(gpu), 20))
    torque = max(rel(g[1], c[1]) for g, c in zip(gpu, cpu))
    swing = all(np.array_equal(g[2], c[2]) for g, c in zip(gpu, cpu))
    held = all(np.array_equal(gpu[t][0], gpu[t - 1][0]) for t in range(len(gpu)) if t % 20)
    print(f"phase 12b: golden lockstep controller.step_batch(solver='ipm_parity') Aliengo h=10 "
          f"trotting10 1.2 m/s B=1, {len(gpu)} ticks on the card in {wall:.1f} s against the "
          f"CPU: solve-tick GRFs max rel {grf:.3e} (bar 1e-4), torques max rel {torque:.3e} "
          f"(bar 1e-3), swing states equal {swing}, forces held between solves {held} [{card}]",
          flush=True)
    check(grf < 1e-4 and torque < 1e-3 and swing and held,
          "phase 12b: the golden lockstep on the card disagrees with the CPU")


def phase_parity_closed_loop(dev, card, solver):
    """Phase 12c: ``srb_env.rollout`` with ``solver`` on phase 3's
    scenarios, CL_TICKS ticks; the band, then the period and its eager
    solve tick."""
    B = B_MAIN
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(dev, B)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    (state_f, carry_f), m = srb_env.rollout(robot, mpc, gait, cmd, CL_TICKS, init_state=state,
                                            solver=solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    finite = all(bool(torch.isfinite(t).all()) for t in (state_f.pos, state_f.vel, state_f.quat))
    diverged = int(m["diverged"].any(dim=0).sum())
    vel_err = m["vel_err"][-CL_TAIL:].mean(dim=0)
    height = state_f.pos[:, 2]
    ok = (~m["diverged"].any(dim=0)) & (vel_err < 0.15) & (height > 0.34) & (height < 0.42)
    share = float(ok.float().mean())
    print(f"phase 12c: rollout solver={solver} B={B} h={HORIZON} {CL_TICKS} ticks (cut from "
          f"phase 8's {N_TICKS} to fit the time limit) in {wall:.1f} s: finite {finite}, "
          f"{diverged} diverged, {int(ok.sum())}/{B} in band over the last {CL_TAIL} ticks "
          f"({share:.4f}, bar {BAND_SHARE}); median vel_err {float(vel_err.median()):.4f} m/s, "
          f"median final height {float(height.median()):.4f} m; hand-kernel launches "
          f"{sum(launches.values())}", flush=True)
    check(finite and diverged == 0 and share >= BAND_SHARE,
          f"phase 12c: rollout {solver} outside the bars")
    loop = srb_env.RolloutLoop(robot, mpc, gait, cmd, PERIOD * 5, init_state=state_f,
                               carry_in=carry_f, tick0=CL_TICKS, solver=solver)
    loop.step()
    for _ in range(PERIOD - 1):
        loop.step()
    period, solve_tick, replay_tick = time_rollout_periods(loop, periods=3)
    print(f"phase 12c: rollout solver={solver} B={B}: one {PERIOD}-tick period {period:.3f} ms "
          f"against the 20 ms real-time limit; eager solve tick {solve_tick:.3f} ms, replayed "
          f"non-solve tick {replay_tick:.3f} ms (medians of 3 periods) [{card}]", flush=True)
    return dict(B=B, period_ms=period, solve_tick_ms=solve_tick, in_band=share, wall_s=wall)


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
    # The fused and full kernels' spills are printed, not gated: at 512
    # threads (128 registers a thread) ptxas spills a few values of each
    # entry in every layout measured (PERF.md section 6).
    for kernel in ("fused", "full"):
        c = admm_cuda.fused_config(libs["admm_fused"].lib, kernel, n, 5 * n // 3)
        ptxas = entry_report(libs["admm_fused"].log, f"admm_{kernel}_kernel")
        print(f"phase 1: admm_{kernel}_kernel at h={HORIZON}: {c['threads']} threads a block, "
              f"{c['blocks_per_sm']} blocks (scenarios) resident per SM, {c['smem_per_block']} B "
              f"of dynamic shared memory per block, {c['workspace_floats']} workspace floats per "
              f"scenario; ptxas: {ptxas}", flush=True)

    max_err = phase_kernel_vs_plain(dev)
    ric_launches, loop_state = phase_closed_loop(dev, "riccati", 3)
    ric_times = phase_times(dev, card, loop_state)
    del loop_state
    cond_err = phase_condensed_vs_plain(dev)
    cond_launches, loop_state = phase_closed_loop(dev, "admm_fast", 6)
    cond_times, backend_launches = phase_condensed_times(dev, card, loop_state)
    del loop_state
    rollout_launches, rollout_times = {}, {}
    for solver in ("riccati", "admm_fast"):
        launches, rollout_times[solver] = phase_rollout(dev, card, solver)
        rollout_launches.update({k: v for k, v in launches.items() if v})
    phase_estimator(dev, card)
    phase_gait_sweep(dev, card)
    t0 = time.perf_counter()
    fo_launches, fo_times = {}, {}
    for part in ("11a", "11b"):
        launches, fo_times[part] = phase_fullorder_trot(dev, card, part)
        fo_launches.update({k: v for k, v in launches.items() if v})
    fo_times["11c"] = phase_fullorder_branches(dev, card)
    fo_wall = time.perf_counter() - t0
    print(f"phase 11: the full-order closed loop took {fo_wall:.1f} s [{card}]", flush=True)
    t0 = time.perf_counter()
    parity = {"engine": phase_parity_engine(dev, card)}
    phase_golden(dev, card)
    parity["rollout"] = {s: phase_parity_closed_loop(dev, card, s) for s in ("admm", "ipm")}
    parity["wall_s"] = time.perf_counter() - t0
    print(f"phase 12: the parity solvers took {parity['wall_s']:.1f} s [{card}]", flush=True)

    kernels = [{
        "name": "riccati_admm", "route": "cuda",
        "source": "pympc_quadruped_tpu_torch/csrc/riccati_admm.cu",
        "replaces": "pympc_quadruped_tpu/ops/qp/riccati_pallas.py:116",
        "launches": rollout_launches["riccati_admm"],
        "launches_in": "rollout(solver='riccati'), 3000 ticks, 150 solves",
        "launches_run_ticks": ric_launches["riccati_admm"],
        "launches_fullorder": fo_launches["riccati_admm"],
        "launches_fullorder_in": FO_LAUNCHES_IN["riccati"], "max_abs_err": max_err,
        "err": "max|dU| [N] vs plain", **ric_times, "library_ms": None,
    }]
    replaces = {"invert_spd": 242, "iterate": 38, "iterate_fused": 374, "solve_full": 417}
    shapes = "; worst of h=16 (B=4096, 130) and h=10 (B=4096)"
    excess = "max f64 relative cost excess over jnp (p99 bar 2e-5, max 1e-4)" + shapes
    errs = {"invert_spd": "f64 residual ratio kernel/plain (bar 2)" + shapes,
            "iterate": excess, "iterate_fused": excess, "solve_full": excess}
    for name in ("invert_spd", "iterate", "iterate_fused", "solve_full"):
        on_loop = name in ("invert_spd", "iterate")
        launches = (rollout_launches[name] if on_loop else
                    backend_launches["pallas_fused" if name == "iterate_fused"
                                     else "pallas_full"][name])
        source = {"invert_spd": "admm.cu", "iterate": "admm_iterate.cu"}.get(name, "admm_fused.cu")
        kernels.append({
            "name": name, "route": "cuda", "source": f"pympc_quadruped_tpu_torch/csrc/{source}",
            "replaces": f"pympc_quadruped_tpu/ops/qp/admm_pallas.py:{replaces[name]}",
            "launches": launches,
            "launches_in": ("rollout(solver='admm_fast'), 3000 ticks, 150 solves" if on_loop else
                            "timed solve_batch runs of its backend"),
            **({"launches_run_ticks": cond_launches[name],
                "launches_fullorder": fo_launches[name],
                "launches_fullorder_in": FO_LAUNCHES_IN["admm_fast"]} if on_loop else {}),
            "max_abs_err": cond_err[name], "err": errs[name], **cond_times[name],
        })
    print(json.dumps({"rollout": rollout_times}))
    print(json.dumps({"fullorder": fo_times}))
    print(json.dumps({"parity": parity}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
