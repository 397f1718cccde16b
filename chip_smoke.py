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
   (bench.py:467-473).  5b, the condensing kernel (``csrc/condense.cu``,
   which ``build_qp`` launches on the card) at B=4096, h=16 and h=10,
   against the plain ``condense.condense`` + ``cones.mask_cost``: per
   scenario max|dH| / max|H| and the same for g below 1e-5, H exactly
   symmetric, masked rows and columns exactly identity with g exactly 0;
   one NaN scenario leaves the others' H and g bitwise unchanged; then the
   kernel alone against the plain version alone (CUDA events, medians),
   and the bytes it writes against 3.35 TB/s;
6. the condensed closed loop: the same scenarios as phase 3 with the
   default ``solver="admm_fast"`` (``pallas_split`` on the card); the
   condensing, invert and iterate kernels must each launch once per solve
   tick;
7. condensed times with CUDA events: one in-loop h=16 solve at B=4096 per
   backend, each kernel alone against its plain version (and the invert
   kernel against ``torch.linalg.inv``), the invert kernel alone without
   its Newton-Schulz step, one 20-tick period;
8. ``srb_env.rollout``, the port's closed-loop entry point, on phase 3's
   scenarios with each solver: its non-solve ticks replay one captured CUDA
   graph.  The first 100 ticks must equal eager ``run_ticks`` bit for bit
   (any leaf that differs is named, and must stay within 1e-6 relative);
   3000 ticks must keep >= 99% in phase 3's band with one host launch of
   each of the solver's kernels per solve tick (150), the eager solve
   between the segments of the loop's tape (``utils/tape.py``), and the
   condensing kernel and the controller's tick kernels launched at the
   loop's build only (:func:`loop_launches`, :func:`loop_ctrl_launches`).
   Then, from tick 3000: the
   20-tick period against the 20 ms limit, the eager solve tick and one
   replayed non-solve tick (CUDA events, medians of 10 periods), the
   graph's kernel and copy nodes, and the device's busy share over two
   periods (``torch.profiler``: kernel time over the periods' time).
   8b, the controller's tick kernels (``csrc/ctrl_tick.cu``: ``srb_observe``,
   ``ctrl_pre``, ``ctrl_post``) at B=4096, h=16 (TROTTING16) and h=10
   (TROTTING10): a Riccati loop brought 200 ticks in, then 40 ticks run
   eagerly with the plain functions (``srb_env.observe``,
   ``controller._pre_solve``, ``_post_solve``), each call's kernel beside
   it on the same CUDA tensors: every float output within 16 float32 ulps
   of its field's largest magnitude (a torque's of its operands), the
   flags, phases, gait table and latches' remaining time equal
   (tests/test_torch_ctrl_tick.py's bounds); each kernel alone (its device
   time, ``torch.profiler``) against its plain function alone, and its
   bytes against 3.35 TB/s;
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
   solver kernel must launch once per solve tick (75) and, as in phase 8,
   the condensing and tick kernels at the loop's build only, and the in-band
   share (tests/test_h16_config.py:99-126, tests/test_rbd.py:400-425) must
   reach min(0.99, the JAX package's share on the same scenarios - 0.01);
   then the period, the eager solve tick, one replayed tick, the graph's
   nodes and ticks/s.  11c, every other captured branch at B=1024: the
   Kalman filter on noisy sensors with measured contact, 2 cm rough
   terrain, ``substeps=2``, ``auto_reset`` and a 400-tick command ramp:
   graph against eager bit for bit, then 1500 ticks finite with no
   scenario diverged;
12. the parity solvers (library calls and PyTorch ops; no hand kernel but
   the condensing one, which ``build_qp`` launches for ``admm_ref``,
   ``ipm`` and the yardstick):
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
   the CPU, and against the port's float64 ``OracleController`` run on the
   card with tests/test_golden_lockstep.py's bars.  12c,
   ``srb_env.rollout`` with ``"admm"`` and ``"ipm"`` on phase
   3's scenarios, 1000 ticks (cut from 3000): finite, none diverged, >=
   99% in the band over the last 250 ticks (tests/test_h16_config.py:61-69
   without the displacement term); the period and the eager solve tick;
13. the sharded sweep (``parallel/{mesh,launch,checkpoint}.py``), two ranks
   on the one card over gloo, each a process of this script started with
   torch's launcher variables (``chip_smoke.py --worker ...``; the kernels
   are built here first): 13a ``solve_sweep_step`` with ``admm_fast`` and
   ``riccati``, B=4096 global, h=10, against the unsharded solve here, held
   to tests/_multihost_worker.py's bars (elementwise 2.0 N, vertical
   support 0.5 N, mean |U| 0.01; tests/test_sharding.py:37's 1e-5 and the
   differing elements printed), each rank launching the solver's kernels;
   13d, alongside it, one NCCL rank (world size 1) through
   ``init_distributed``, its reductions bitwise those of no group and a
   short ``rollout_sweep`` over the group; 13b the sweep entry point
   (``examples/sweep.py``), Aliengo, h=10, B=4096 global over trotting10 /
   pacing10 / bounding8, 3 chunks of 500 ticks with a checkpoint each:
   per-gait survival and tracking at phase 10's bars, no divergence, each
   rank launching the invert and iterate kernels; its ticks/s, checkpoint
   bytes and save times; 13c the same stopped after one chunk and resumed
   by fresh processes, its final checkpoint bitwise 13b's; and the cost of
   a rank's drawing the global batch's sensor noise;
14. the user surfaces on the card.  14a, the MuJoCo example's controller
   adapter (``examples/mujoco_closed_loop.make_torch_controller``) at B=1,
   h=10, TROTTING10 at 1.2 m/s, ``admm_fast``, 2000 ticks, driving
   ``fullorder.physics_step`` at B=1 through host numpy each tick (the
   card's machine has no MuJoCo): phase 11b's band, 100 launches each of
   the invert and iterate kernels, the first five B=1 solves against the
   plain version with phase 5's invariants, and the controller tick's p50
   and p99 (solve ticks and others) beside the reference's 20 ms and 1 ms,
   not gated; the condensing kernel launches once a solve too.  14b,
   ``examples/batch_viz.record_batch`` at B=4096 (mixed
   trotting10 / pacing10 / bounding8, a speed ramp), 38 frames of 40 ticks
   (cut from the example's 3 s): one graph capture, the per-gait share that
   never diverges and ends in a height band at or above the JAX package's
   less one point, ticks/s.  14c (no kernel), the SE(3)/PoE functions of
   ``ops/lie.py`` on the card against the CPU, the PoE leg FK against
   ``kin``, and ``condense.qp_cost_toeplitz`` against the Gram condensing
   at B=4096, h=16, with both times.  14d, through each kernel backend
   (``pallas_split``, ``pallas_fused``, ``pallas_full``, ``riccati``), one
   NaN scenario of a B=4096 batch leaves every other scenario bitwise
   unchanged;
15. the float64 golden model (``oracle/``, no hand kernel) on the card.
   15a, the main path's first solve tick (phase 12a's B=4096, h=16
   problems) condensed by the oracle's own batched ``_condensed_qp`` and
   solved by ``solve_qp_kkt``: every certificate below 1e-7; the first 256
   scenarios by the oracle on the CPU within 1e-8 of (1 + |U|); 8 through
   the C++ oracle (``csrc/qp_oracle.cc``) at the same f64 cost; the
   oracle's H and g against the port's float64 condensing within 1e-9 of
   max|H|, and ``build_qp_ff``'s (float32 discretization) within 1e-6;
   its wall time and iterations.  15b, each solve route against the
   certified optimum U* on those problems: the four kernel backends
   (``riccati``; ``pallas_split``, ``pallas_fused`` and ``pallas_full`` at
   the in-loop preset, cold), the yardstick and the three parity routes:
   the f64 cost excess, max|U - U*|, the first-step fz error and the cone
   violation at p50 / p99 / max; the yardstick and the parity routes held
   to phase 12a's bars against U*, the kernel backends to finite, swing
   forces exactly 0 and the worst cone row within 5x the cone share, their
   excess printed (above tests/test_riccati.py's h=16 bar at p99: a
   finding); each kernel launched by its route, and the condensing kernel
   once by each route through ``build_qp`` (six).  15c, the MuJoCo example's
   oracle controller (``make_oracle_controller``) at B=1 on
   ``fullorder.physics_step`` through host numpy, 1000 ticks in phase
   11a's configuration held to its band, and in the example's defaults
   (phase 11b's) printed; no kernel launched; the oracle's tick times.

The last lines are the kernel summary, the condensing kernel's, and the
device record.  Imports
torch, numpy and the port only.  ``--worker`` runs one process of phase 13.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from pympc_quadruped_tpu_torch import _build, engine, tree
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.control import ctrl_cuda, refmpc
from pympc_quadruped_tpu_torch.env import fullorder, graph_loop, mjcf, srb_env, terrain
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.examples.batch_viz import record_batch
from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import (OBS_KEYS,
                                                                    make_oracle_controller,
                                                                    make_torch_controller)
from pympc_quadruped_tpu_torch.loop import run_ticks
from pympc_quadruped_tpu_torch.models import Command, Gaits, a1, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.parallel import checkpoint, launch, sweep
from pympc_quadruped_tpu_torch.ops import condense, kin, lie, srb
from pympc_quadruped_tpu_torch.ops.kin import RobotObs
from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, admm_fast, cones, ipm, riccati, riccati_cuda
from pympc_quadruped_tpu_torch.oracle import cpp as oracle_cpp
from pympc_quadruped_tpu_torch.oracle import npref
from pympc_quadruped_tpu_torch.utils import observability, profiling

B_MAIN, B_RAGGED, HORIZON = 4096, 130, 16
N_TICKS, BAND_TICKS, PERIOD = 3000, 750, 20
CTRL_WARM_TICKS = 200
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


def closed_loop_setup(dev, B=None, h=HORIZON):
    """The trot scenarios of the closed loops, B_MAIN of them by default, at
    horizon ``h`` (TROTTING16 at h=16, TROTTING10 at h=10)."""
    B = B or B_MAIN
    mpc = default_mpc_params(h, device=dev)
    robot = tree.tile(aliengo(device=dev), B)
    gait = tree.tile(Gaits.by_name("trotting16" if h == 16 else "trotting10", device=dev), B)
    cmd = tree.tile(Command.trot_forward(1.2, device=dev), B)
    carry = tree.tile(ctrl.init_carry(h, device=dev), B)
    return mpc, robot, gait, cmd, carry, jittered_init(robot, B, seed=31, dev=dev)


def kernel_launches() -> dict:
    """The solvers' and the condensing kernel's host launches."""
    return {"riccati_admm": riccati_cuda.LAUNCHES, **admm_cuda.LAUNCHES}


def loop_launches(name: str, on_path: tuple, n_solves: int) -> int:
    """Host launches of kernel ``name`` by one closed loop built on the card
    and run for ``n_solves`` solve ticks: the solver's kernels once a solve
    tick (the eager solve between the segments of the loop's tape,
    utils/tape.py); the condensing kernel, which the tape's graphs replay,
    three times, all at the loop's build (the tape's two warm-up ticks and
    its recording)."""
    if name not in on_path:
        return 0
    return 3 if name == "condense" else n_solves


def loop_ctrl_launches(traced: int, observe: bool) -> dict:
    """Host launches of each controller tick kernel by one closed loop built
    on the card, whatever its ticks: one a call of the tick at the build
    (the graph's two warm-up calls and its capture, ``traced`` traced
    captures, the tape's two warm-up calls and its recording), none when a
    tick replays the graph or plays the tape; ``srb_observe`` with the SRB
    plant only."""
    n = 6 + traced
    return {"srb_observe": n if observe else 0, "ctrl_pre": n, "ctrl_post": n}


def reset_launches():
    riccati_cuda.LAUNCHES = 0
    for launches in (admm_cuda.LAUNCHES, ctrl_cuda.LAUNCHES):
        for name in launches:
            launches[name] = 0


def traced_captures() -> int:
    return profiling.snapshot()["counters"].get("capture.traced", 0)


# ---------------------------------------------------------------------------
# The controller's tick kernels (csrc/ctrl_tick.cu)
# ---------------------------------------------------------------------------

# Each float output of a tick kernel within CTRL_ULPS float32 ulps of the
# largest magnitude of its field (a torque's of its operands,
# :func:`torque_scale`); the CTRL_EXACT fields, which take no product, and
# the flags bit for bit (tests/test_torch_ctrl_tick.py states why).
CTRL_ULPS = 16.0
CTRL_EXACT = {"swing_states", "table", "remaining_swing_time"}
PRE_NAMES = ("kin", "swing_states", "table", "x_t", "mpc", "vel_des_world")
POST_NAMES = ("swing", "pos_targets", "vel_targets", "torques")
CTRL_KERNELS = ("srb_observe", "ctrl_pre", "ctrl_post")
CTRL_SHADOW_TICKS = 40


def torque_scale(robot, ks, forces, swing_states, pos_t, vel_t):
    """The largest magnitude of the operands behind one torque, which its
    float32 rounding scales with: ``legctrl.leg_torques``' J^T R^T f, a
    swing leg's f = kp (p_t - p) R^T + kd (v_t - v) R^T taken with each
    target and foot term at its own size.  A swing leg's PD terms of
    ~60 N can cancel to a torque of ~2 N m."""
    Ra = ks.R_base.abs()
    RaT = Ra.transpose(-1, -2)
    swing = (robot.kp_swing[..., None, :] * ((pos_t.abs() + ks.base_pos_base_feet.abs()) @ RaT)
             + robot.kd_swing[..., None, :] * ((vel_t.abs() + ks.base_vel_base_feet.abs()) @ RaT))
    f = torch.where((swing_states != 0)[..., None], swing, forces.reshape(-1, 4, 3).abs()) @ Ra
    return (ks.jac_feet.abs() * f[..., :, None]).sum(dim=-2).max()


def ctrl_errors(worst, kernel, got, want, scales=None):
    """Fold each output's error into ``worst[name] = (error, bound)``
    (device tensors, no host read): ulps of its field's largest magnitude
    (or of ``scales[field]``), bound CTRL_ULPS; for the CTRL_EXACT fields
    and flags the number of elements that differ, bound 0."""
    eps = torch.finfo(torch.float32).eps
    g = tree.flatten(got)
    scales = scales or {}
    for k, w in tree.flatten(want).items():
        if (w.dtype == torch.bool or k.split("/")[0] in CTRL_EXACT
                or k.rsplit("/", 1)[-1] in CTRL_EXACT):
            r, bound = (g[k] != w).sum().float(), 0.0
        else:
            scale = scales[k] if k in scales else w.abs().max()
            r, bound = (g[k] - w).abs().max() / (eps * scale.clamp(min=1e-6)), CTRL_ULPS
        name = f"{kernel}/{k}"
        worst[name] = (r if name not in worst else torch.maximum(worst[name][0], r), bound)


def shadow_ctrl_kernels(patch, lib=None) -> dict:
    """Make a closed loop run the plain functions and, beside each call, its
    kernel on the same tensors (through ``lib``, by default the CUDA
    library); ``patch(obj, name, value)`` sets a module attribute.  Returns
    the dict that :func:`ctrl_errors` fills."""
    worst = {}
    pre, post, observe = ctrl._pre_solve, ctrl._post_solve, srb_env.observe
    patch(ctrl_cuda, "engages", lambda *a: False)

    def pre_(robot, mpc, gait, cmd, carry, obs, tick):
        want = pre(robot, mpc, gait, cmd, carry, obs, tick)
        got = ctrl_cuda.ctrl_pre(robot, mpc, gait, cmd, carry.mpc, obs, tick, lib=lib)
        ctrl_errors(worst, "ctrl_pre", dict(zip(PRE_NAMES, got)), dict(zip(PRE_NAMES, want)))
        return want

    def post_(robot, mpc, gait, cmd, carry, ks, swing_states, mpc_carry, forces):
        want = post(robot, mpc, gait, cmd, carry, ks, swing_states, mpc_carry, forces)
        got = ctrl_cuda.ctrl_post(robot, mpc, gait, cmd, ks, carry.swing, swing_states, forces,
                                  lib=lib)
        w = (want[0].swing, want[1].pos_targets, want[1].vel_targets, want[1].torques)
        scale = torque_scale(robot, ks, forces, swing_states, w[1], w[2])
        ctrl_errors(worst, "ctrl_post", dict(zip(POST_NAMES, got)), dict(zip(POST_NAMES, w)),
                    {"torques": scale})
        return want

    def observe_(robot, state):
        want = observe(robot, state)
        ctrl_errors(worst, "srb_observe", ctrl_cuda.srb_observe(robot, state, lib=lib), want)
        return want

    patch(ctrl, "_pre_solve", pre_)
    patch(ctrl, "_post_solve", post_)
    patch(srb_env, "observe", observe_)
    return worst


@contextlib.contextmanager
def patched():
    """A ``patch(obj, name, value)`` whose settings are undone on exit."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        yield patch
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def ctrl_tick_bytes(B: int, h: int) -> dict:
    """Bytes each tick kernel reads and writes once: float rows, int32 gait
    rows, one-byte flags (csrc/ctrl_tick.cu's operands)."""
    f4 = 4 * B
    return {
        "srb_observe": f4 * (55 + 24),
        "ctrl_pre": f4 * (61 + 9) + 2 * B + f4 * (9 + 3 + 5 * 12 + 36 + 4 + 4 * h + 13 + 3 + 3),
        "ctrl_post": f4 * (155 + 5) + 8 * B + f4 * (4 + 5 * 12),
    }


def kernel_device_ms(fn, reps=50) -> float:
    """Mean device time of the tick kernel that each ``fn()`` launches
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA and "tick_kernel" in ev.name]
    check(len(us) == reps, f"the profiler recorded {len(us)} tick kernels of {reps} launched")
    return sum(us) / reps / 1e3


def phase_ctrl_tick(dev, card):
    """Phase 8b: the controller's tick kernels at B=4096, h=16 and h=10: a
    Riccati closed loop brought CTRL_WARM_TICKS ticks in through its graph,
    then CTRL_SHADOW_TICKS ticks run eagerly with the plain functions, each
    call's kernel beside it on the same CUDA tensors, every output within
    CTRL_ULPS (the flags and exact fields equal); then at that state each
    kernel alone (its device time) against its plain function alone (CUDA
    events), and its bytes against 3.35 TB/s."""
    out = {}
    for h in (HORIZON, 10):
        mpc, robot, gait, cmd, _, state = closed_loop_setup(dev, h=h)
        loop = srb_env.RolloutLoop(robot, mpc, gait, cmd, CTRL_WARM_TICKS + CTRL_SHADOW_TICKS,
                                   init_state=state, solver="riccati")
        for _ in range(CTRL_WARM_TICKS):
            loop.step()
        robot, gait, cmd = loop.robot, loop.gait, loop.cmd
        with patched() as patch:
            worst = shadow_ctrl_kernels(patch)
            for t in range(CTRL_WARM_TICKS, CTRL_WARM_TICKS + CTRL_SHADOW_TICKS):
                loop._tick(loop.buf, solve=ctrl.is_solve_tick(mpc, t))
        errs = {k: (float(e), b) for k, (e, b) in worst.items()}
        check({k.split("/")[0] for k in errs} == set(CTRL_KERNELS),
              f"phase 8b: h={h}: kernels compared {sorted(errs)}")
        over = {k: e for k, (e, b) in errs.items() if e > b}
        state, carry, tick = loop.buf.state, loop.buf.carry, loop.buf.tick
        forces = carry.mpc.contact_forces
        obs = ctrl_cuda.srb_observe(robot, state)
        ks, swing_states, *_ = ctrl_cuda.ctrl_pre(robot, mpc, gait, cmd, carry.mpc, obs, tick)
        calls = {
            "srb_observe": lambda: srb_env.observe(robot, state),
            "ctrl_pre": lambda: ctrl._pre_solve(robot, mpc, gait, cmd, carry, obs, tick),
            "ctrl_post": lambda: ctrl._post_solve(robot, mpc, gait, cmd, carry, ks, swing_states,
                                                  carry.mpc, forces),
        }
        nbytes = ctrl_tick_bytes(B_MAIN, h)
        rec = {}
        for name, fn in calls.items():
            ms = kernel_device_ms(fn)
            with patched() as patch:
                patch(ctrl_cuda, "engages", lambda *a: False)
                plain_ms = cuda_ms(fn, reps=5)
            bound, by = bound_ms(0.0, nbytes[name])
            floats = [e for k, (e, b) in errs.items() if k.startswith(name + "/") and b]
            exact = [e for k, (e, b) in errs.items() if k.startswith(name + "/") and not b]
            rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             bytes=nbytes[name], max_ulps=max(floats), exact_differ=sum(exact))
            print(f"phase 8b: {name} h={h} B={B_MAIN}: against the plain function over "
                  f"{CTRL_SHADOW_TICKS} ticks of the closed loop, worst {max(floats):.2f} ulps "
                  f"of a field (bar {CTRL_ULPS:g}), {int(sum(exact))} elements of the exact "
                  f"fields and flags differ; kernel alone {ms * 1e3:.1f} us, plain alone "
                  f"{plain_ms:.3f} ms ({plain_ms / ms:.0f}x); {nbytes[name] / 1e6:.2f} MB, "
                  f"bound {bound * 1e3:.2f} us ({by}) [{card}]", flush=True)
        check(not over, f"phase 8b: h={h}: outside the bars: {over}")
        out[h] = rec
        del loop
    return out


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
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate", "condense")
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


def trot_qp_inputs(B, seed, dev, h=HORIZON):
    """Trot-like ``build_qp`` inputs (h=16 unless given), made with numpy:
    jittered states near 1.2 m/s, a forward-moving reference, the
    TROTTING16 stance table at a random phase per scenario.  Returns (mpc,
    robot, x_t, yaw, feet, X_ref (B,h,13), table) and the generator."""
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
    return (mpc, robot, T(x_t), T(yaw), T(feet), T(X_ref), T(table)), rng


def condensed_problem(B, seed, dev, h=HORIZON) -> CondensedProblem:
    """Condensed problems from the port's ``build_qp`` on
    :func:`trot_qp_inputs`; also a warm start in problem units: a converged
    plain solve perturbed by 5 N."""
    (mpc, robot, x_t, yaw, feet, X_ref, table), rng = trot_qp_inputs(B, seed, dev, h)
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    H, g, mv = refmpc.build_qp(robot, mpc, x_t, yaw, feet, X_ref, table)
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


#: The condensing kernel against the plain condensing (``condense.condense``
#: + ``cones.mask_cost``), per scenario: max |dH| over max |H|, and the same
#: for g, as the benchmark's ``qp_data`` reads an operand.  The kernel's
#: host build reads at most 7.9e-7 against it at h = 10 and 16
#: (tests/test_torch_condense.py's KERNEL_REL_TOL); the bar is a third of
#: ``qp_data``'s 3e-5 limit (benchmark/workloads/srb-h16-trot-admm.json).
CONDENSE_REL_BAR = 1e-5
#: Scenario CONDENSE_FLIGHT of the check's batch has all four legs in flight
#: at steps 2 and 3 of its horizon.
CONDENSE_FLIGHT = 5


def condense_operands(B, h, seed, dev):
    """The condensing's operands (mpc, (Ad, Bd, x_t, X_ref, mv)) of
    :func:`trot_qp_inputs`, discretised as ``build_qp`` does, with swing
    legs masked and scenario CONDENSE_FLIGHT in flight for two steps."""
    (mpc, robot, x_t, yaw, feet, X_ref, table), _ = trot_qp_inputs(B, seed, dev, h)
    table[CONDENSE_FLIGHT % B, 8:16] = 0.0
    Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
    return mpc, (Ad, Bd, x_t, X_ref, cones.variable_mask(table, mpc))


def plain_condense(mpc, Ad, Bd, x_t, X_ref, mv):
    """What ``build_qp`` computes off the card: the plain masked condensing."""
    return cones.mask_cost(*condense.condense(Ad, Bd, x_t, X_ref, mpc), mv)


def condense_report(H, g, H_ref, g_ref, mv) -> dict:
    """The kernel's (H, g) against the plain version's: per scenario max
    gap over max |ref| (worst over the batch), H exactly symmetric, the
    masked rows and columns exactly identity, g exactly 0 there."""
    def rel(a, b):
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        return float(((a.double() - b.double()).abs().amax(-1)
                      / b.double().abs().amax(-1).clamp(min=1e-30)).max())

    swing = mv == 0
    pinned = swing[:, :, None] | swing[:, None, :]
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device).expand_as(H)
    return dict(H_rel=rel(H, H_ref), g_rel=rel(g, g_ref),
                symmetric=bool(torch.equal(H, H.transpose(-1, -2))),
                pinned_identity=bool(torch.equal(H[pinned], eye[pinned])),
                pinned_g_zero=bool((g[swing] == 0).all()), masked=int(swing.sum()))


def condense_ok(r: dict) -> bool:
    return (r["H_rel"] < CONDENSE_REL_BAR and r["g_rel"] < CONDENSE_REL_BAR and r["symmetric"]
            and r["pinned_identity"] and r["pinned_g_zero"])


def condense_nan_isolation(mpc, ops) -> dict:
    """The kernel with and without scenario NAN_ROW's x_t made NaN: how many
    elements of the other scenarios' H and g differ."""
    Ad, Bd, x_t, X_ref, mv = ops
    row = NAN_ROW % len(x_t)
    bad = x_t.clone()
    bad[row] = float("nan")
    H, g = admm_cuda.condense(Ad, Bd, x_t, X_ref, mv, mpc)
    H2, g2 = admm_cuda.condense(Ad, Bd, bad, X_ref, mv, mpc)
    torch.cuda.synchronize()
    keep = torch.arange(len(x_t), device=x_t.device) != row
    return {"others_differ": int((H[keep] != H2[keep]).sum() + (g[keep] != g2[keep]).sum()),
            "poisoned_finite": bool(torch.isfinite(g2[row]).all())}


def phase_condense(dev, card, libs):
    """Phase 5b: the condensing kernel at B=4096, h=16 and h=10, against the
    plain masked condensing; NaN isolation; then the kernel alone against
    the plain version alone, and the bytes it writes against 3.35 TB/s."""
    out = {}
    for h in (HORIZON, 10):
        occ = admm_cuda.condense_occupancy(libs["condense"].lib, h)
        mpc, ops = condense_operands(B_MAIN, h, 19, dev)
        before = dict(admm_cuda.LAUNCHES)
        H, g = admm_cuda.condense(*ops, mpc)
        torch.cuda.synchronize()
        launched = {k: admm_cuda.LAUNCHES[k] - before[k] for k in before}
        check(launched == {**{k: 0 for k in before}, "condense": 1},
              f"phase 5b: h={h}: launches {launched}, expected condense 1")
        r = condense_report(H, g, *plain_condense(mpc, *ops), ops[-1])
        del H, g
        nan = condense_nan_isolation(mpc, ops)
        B, n = B_MAIN, 12 * h
        plain_fn = lambda: plain_condense(mpc, *ops)
        kernel_fn = lambda: admm_cuda.condense(*ops, mpc)
        # In turns: plain, kernel, kernel, plain (the second of each is kept).
        cuda_ms(plain_fn, reps=3)
        cuda_ms(kernel_fn, reps=3)
        t_kernel = cuda_ms(kernel_fn)
        t_plain = cuda_ms(plain_fn, reps=5)
        written = 4 * B * (n * n + n)
        read = 4 * B * (13 * 13 + 13 * 12 + 13 + 13 * h + n)
        bound, by = bound_ms(B * 2 * (h * (h + 1) // 2 * 12 * 12 * 13 + h * 13 * 13 * 12),
                             written + read)
        r.update(nan, ms=t_kernel, plain_ms=t_plain, bound_ms=bound, bound_by=by,
                 written_bytes=written, write_only_ms=written / PEAK_BYTES * 1e3, **occ)
        out[h] = r
        print(f"phase 5b: condense kernel h={h} B={B}: H max|d|/max|H| {r['H_rel']:.3e}, g "
              f"{r['g_rel']:.3e} against the plain condensing (bar {CONDENSE_REL_BAR:g} per "
              f"scenario); H exactly symmetric {r['symmetric']}; {r['masked']} masked "
              f"variables, their rows and columns exactly identity {r['pinned_identity']}, g "
              f"exactly 0 {r['pinned_g_zero']}; NaN in scenario {NAN_ROW % B}: "
              f"{nan['others_differ']} elements of the others' H and g differ; "
              f"{occ['blocks_per_sm']} blocks (scenarios) resident per SM, "
              f"{occ['smem_per_block']} B of shared memory per block", flush=True)
        print(f"phase 5b: condense kernel alone h={h} B={B}: {t_kernel:.3f} ms, plain condense "
              f"+ mask_cost {t_plain:.3f} ms ({t_plain / t_kernel:.1f}x); writes "
              f"{written / 1e6:.1f} MB, {r['write_only_ms']:.3f} ms at 3.35 TB/s "
              f"({100 * r['write_only_ms'] / t_kernel:.1f}% of it); bound {bound:.3f} ms "
              f"({by}) [{card}]", flush=True)
        check(condense_ok(r), f"phase 5b: h={h}: the condensing kernel outside the bars")
        check(nan["others_differ"] == 0, f"phase 5b: h={h}: a NaN scenario moved the others")
    return out


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
    traced0 = traced_captures()
    t0 = time.perf_counter()
    (state_f, carry_f), m = srb_env.rollout(robot, mpc, gait, cmd, N_TICKS, init_state=state,
                                            solver=solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    n_solves = N_TICKS // PERIOD
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate", "condense")
    for name, count in launches.items():
        want = loop_launches(name, on_path, n_solves)
        check(count == want,
              f"rollout {solver}: kernel {name} launched {count} times, expected {want}")
    ctrl_n, want = dict(ctrl_cuda.LAUNCHES), loop_ctrl_launches(traced_captures() - traced0, True)
    check(ctrl_n == want, f"rollout {solver}: controller kernels launched {ctrl_n}, expected {want}")
    check(all(tuple(v.shape) == (N_TICKS, B) for v in m.values()), "rollout metric shapes")
    vel_err = m["vel_err"][-BAND_TICKS:].mean(dim=0)
    height, x = state_f.pos[:, 2], state_f.pos[:, 0]
    ok = ((~m["diverged"].any(dim=0)) & (vel_err < 0.15) & (height > 0.34) & (height < 0.42)
          & (x > 2.0))
    share = float(ok.float().mean())
    counts = ", ".join(f"{k} {v}" for k, v in [*((k, launches[k]) for k in on_path),
                                                *ctrl_n.items()])
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
    nodes = profiling.graph_nodes(loop.graph)
    for _ in range(2 * PERIOD):
        loop.step()
    period, solve_tick, replay_tick = time_rollout_periods(loop)
    busy = busy_share(loop)
    print(f"phase 8: rollout solver={solver} B={B}: one {PERIOD}-tick period {period:.3f} ms "
          f"against the 20 ms real-time limit; eager solve tick {solve_tick:.3f} ms, replayed "
          f"non-solve tick {replay_tick:.3f} ms; graph of the non-solve tick: {nodes} nodes, "
          f"captured in {capture_s:.2f} s (setup included); device busy {busy:.3f} of two "
          f"periods (profiler on) [{card}]", flush=True)
    return {**launches, **ctrl_n}, dict(period_ms=period, solve_tick_ms=solve_tick,
                                        replay_tick_ms=replay_tick, graph_nodes=nodes,
                                        busy_share=busy)


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


#: Phase 14b: ``examples/batch_viz.record_batch`` at the main path's batch:
#: Aliengo, h=10, the default solver, the example's mixed gaits (scenario i
#: runs BV_GAITS[i % 3]) and speed ramp (0.6-1.0 x BV_VX down the rows),
#: from the nominal stance, frames every BV_FRAME_TICKS ticks.  The
#: example's 3.0 s are cut to 1.5 s to fit the time limit; its loop runs
#: whole frames (range(0, 1500, 40): 38 frames, 1520 ticks).
BV_B, BV_SECONDS, BV_FRAME_TICKS, BV_VX = 4096, 1.5, 40, 0.6
BV_FRAMES = len(range(0, int(BV_SECONDS * 1000), BV_FRAME_TICKS))
BV_TICKS = BV_FRAMES * BV_FRAME_TICKS
BV_GAITS = ("trotting10", "pacing10", "bounding8")
#: The band on the mean trunk height over the last FO_TAIL ticks: the
#: MuJoCo gate's for pacing and bounding (tests/test_mujoco_e2e.py:90).
BV_HEIGHT_BAND = (0.33, 0.45)


def batch_viz_in_band(metrics: dict) -> torch.Tensor:
    """(B,) bool: no divergence on any tick, a finite height on every tick,
    and the mean height over the last FO_TAIL ticks inside BV_HEIGHT_BAND."""
    lo, hi = BV_HEIGHT_BAND
    height = metrics["height"]
    h = height[-FO_TAIL:].mean(dim=0)
    return (torch.isfinite(height).all(dim=0) & ~metrics["diverged"].any(dim=0)
            & (h > lo) & (h < hi))


def per_gait_share(ok: torch.Tensor) -> dict:
    """The in-band share of each of BV_GAITS' scenarios (i % 3)."""
    return {name: float(ok[i::3].float().mean()) for i, name in enumerate(BV_GAITS)}


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
    traced0 = traced_captures()
    t0 = time.perf_counter()
    (state, carry), m = fullorder.rollout(*args, FO_TICKS, state0=state0, solver=solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    n_solves = FO_TICKS // PERIOD
    on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate", "condense")
    for name, count in launches.items():
        want = loop_launches(name, on_path, n_solves)
        check(count == want,
              f"phase {part}: kernel {name} launched {count} times, expected {want}")
    ctrl_n, want = dict(ctrl_cuda.LAUNCHES), loop_ctrl_launches(traced_captures() - traced0, False)
    check(ctrl_n == want, f"phase {part}: controller kernels launched {ctrl_n}, expected {want}")
    check(all(tuple(v.shape) == (FO_TICKS, B) for v in m.values()), "fullorder metric shapes")
    ok = fullorder_in_band(m, state.pos[:, 0], p["band"])
    share = float(ok.float().mean())
    bar = min(BAND_SHARE, FO_REFERENCE_SHARE[part] - 0.01)
    counts = ", ".join(f"{k} {v}" for k, v in [*((k, launches[k]) for k in on_path),
                                                *ctrl_n.items()])
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
    nodes = profiling.graph_nodes(loop.graph)
    for _ in range(2 * PERIOD):
        loop.step()
    period, solve_tick, replay_tick = time_rollout_periods(loop)
    print(f"phase {part}: fullorder solver={solver} B={B}: one {PERIOD}-tick period "
          f"{period:.3f} ms ({B * PERIOD / period * 1e3:.0f} ticks/s) against the 20 ms "
          f"real-time limit; eager solve tick {solve_tick:.3f} ms, replayed non-solve tick "
          f"{replay_tick:.3f} ms; graph of the non-solve tick: {nodes} nodes, captured in "
          f"{capture_s:.2f} s (setup included) [{card}]", flush=True)
    return {**launches, **ctrl_n}, dict(
        period_ms=period, solve_tick_ms=solve_tick, replay_tick_ms=replay_tick,
        ticks_per_s=B * PERIOD / period * 1e3, graph_nodes=nodes, in_band=share, bar=bar,
        wall_s=wall)


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


#: Phase 12b's bars against the float64 oracle, tests/test_golden_lockstep.py's:
#: swing states (absolute, :133), solve-tick GRFs (worst relative to 1 + |f|,
#: :157), total vertical support (:167), swing-leg torques (:181), all
#: torques (:192).
GOLDEN_BARS = {"swing": 1e-5, "grf": 1e-4, "support": 1e-5, "swing_torque": 2e-3,
               "torque": 1e-3}


def golden_oracle_run(dev, ticks=200):
    """The port's float64 ``OracleController`` (Aliengo, h=10, TROTTING10 at
    1.2 m/s) over ``ticks`` ticks of golden_obs: the per-tick (forces,
    torques, swing states) as float64 numpy arrays."""
    oc = npref.OracleController(npref.oracle_aliengo(dev),
                                npref.OracleConfig(horizon=10, device=dev),
                                npref.OracleGait.trotting10(dev))
    rows = []
    for tick in range(ticks):
        obs = dict(zip(OBS_KEYS, golden_obs(tick).values()))
        out = oc.step(obs, [1.2, 0.0, 0.0], 0.0, tick)
        rows.append(tuple(out[k].cpu().numpy() for k in ("forces", "torques", "swing_states")))
    return rows


def golden_deviation(port, oracle) -> dict:
    """tests/test_golden_lockstep.py's five measures of the port's rows
    against the oracle's (GOLDEN_BARS' keys)."""
    rel = lambda a, b: float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
    solves = range(0, len(port), PERIOD)
    fz = lambda f: float(f.reshape(4, 3)[:, 2].sum())
    return {
        "swing": max(float(np.abs(p[2] - o[2]).max()) for p, o in zip(port, oracle)),
        "grf": max(rel(port[t][0], oracle[t][0]) for t in solves),
        "support": max(abs(fz(port[t][0]) - fz(oracle[t][0])) / (1.0 + abs(fz(oracle[t][0])))
                       for t in solves),
        "swing_torque": max([rel(p[1][3 * leg:3 * leg + 3], o[1][3 * leg:3 * leg + 3])
                             for p, o in zip(port, oracle) for leg in range(4) if o[2][leg] > 0],
                            default=0.0),
        "torque": max(rel(p[1], o[1]) for p, o in zip(port, oracle)),
    }


def phase_golden(dev, card):
    """Phase 12b: the golden lockstep's 200 ticks on the card against the
    same ticks run by the port on the CPU, and against the port's float64
    oracle run on the card."""
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
    t0 = time.perf_counter()
    oracle = golden_oracle_run(dev)
    o_wall = time.perf_counter() - t0
    dev_o = golden_deviation(gpu, oracle)
    print(f"phase 12b: the same {len(gpu)} card ticks against the float64 OracleController on "
          f"the card ({o_wall:.1f} s): swing states max |d| {dev_o['swing']:.3e} (bar "
          f"{GOLDEN_BARS['swing']:g}), solve-tick GRFs max rel {dev_o['grf']:.3e} (bar "
          f"{GOLDEN_BARS['grf']:g}), vertical support max rel {dev_o['support']:.3e} (bar "
          f"{GOLDEN_BARS['support']:g}), swing torques max rel {dev_o['swing_torque']:.3e} (bar "
          f"{GOLDEN_BARS['swing_torque']:g}), torques max rel {dev_o['torque']:.3e} (bar "
          f"{GOLDEN_BARS['torque']:g}), forces held between solves {held} [{card}]", flush=True)
    check(all(dev_o[k] < bar for k, bar in GOLDEN_BARS.items()) and held,
          "phase 12b: the golden lockstep on the card disagrees with the float64 oracle")


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


# ---------------------------------------------------------------------------
# Phase 13: the sharded sweep (parallel/{mesh,launch,checkpoint}.py)
# ---------------------------------------------------------------------------

#: Phase 13's global batch, horizon, gaits and ranks (two ranks share the card).
SH_B, SH_H, SH_RANKS = 4096, 10, 2
SH_GAITS = ["trotting10", "pacing10", "bounding8"]
#: 13b's chunks (cut 13b before any earlier phase): 3 x 500 ticks.
SH_SECONDS, SH_CHUNK = 1.5, 500
#: tests/_multihost_worker.py's bars for a sharded against an unsharded
#: solve: elementwise [N], each scenario's first-step vertical support [N],
#: the mean |U| [N]; and tests/test_sharding.py:37's elementwise bar.
SH_ELEM_BAR, SH_SUPPORT_BAR, SH_MEAN_BAR, SH_EXACT_BAR = 2.0, 0.5, 0.01, 1e-5
#: 13a's elementwise bar [N] for each solver, inside SH_ELEM_BAR: riccati's
#: rows are bitwise the unsharded rows; admm_fast's differ because the
#: condensing's batched GEMMs round by batch size (PERF.md section 7), by
#: 1.74e-2 N at most on the H100, held to about three times that.
SH_SOLVER_BAR = {"riccati": SH_EXACT_BAR, "admm_fast": 0.05}
SH_SOLVERS = ("admm_fast", "riccati")


def sweep_solve_inputs(B, h, dev, seed=13):
    """Trot-like (x_t, yaw, feet, X_ref, table) for ``solve_sweep_step``, made
    with numpy from ``seed`` (the family of tests/test_torch_condense.py's
    inputs), TROTTING10's stance table at a random phase per scenario."""
    rng = np.random.default_rng(seed)
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
    X_ref[:, :, 5], X_ref[:, :, 9], X_ref[:, :, 12] = 0.38, 1.2, -9.81
    seg = (rng.integers(0, 10, B)[:, None] + np.arange(h)) % 10 < 5          # (B,h)
    table = np.stack([seg, ~seg, ~seg, seg], axis=-1).reshape(B, 4 * h)
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    return tuple(map(T, (x_t, yaw, feet, X_ref.reshape(B, h * 13), table)))


def differing_leaves(a, b) -> list:
    """Paths of the tensor leaves of two trees that are not bit for bit equal."""
    fa, fb = tree.flatten(a), tree.flatten(b)
    check(fa.keys() == fb.keys(), "the trees differ in structure")
    return [k for k in fa if not torch.equal(fa[k], fb[k])]


def worker_json(out: str, kind: str) -> dict:
    rows = [json.loads(l) for l in out.splitlines() if l.startswith('{"worker": "%s"' % kind)]
    check(len(rows) == 1, f"a {kind} worker printed no result:\n{out[-2000:]}")
    return rows[0]


def worker_solve(rank, nprocs, port, outdir):
    """13a, one rank: the global batch made from the seed, this rank's rows
    solved with each solver, the rows saved for the parent."""
    from pympc_quadruped_tpu_torch.parallel import launch, mesh as mesh_lib

    backend = launch.init_distributed(f"localhost:{port}", nprocs, rank)
    mesh = launch.global_data_mesh()
    dev = mesh.device
    robot = tree.tile(aliengo(device=dev), SH_B)
    args = mesh_lib.shard_global_batch((robot, *sweep_solve_inputs(SH_B, SH_H, dev)), mesh)
    mpc = default_mpc_params(SH_H, device=dev)
    rows, launches = {}, {}
    for solver in SH_SOLVERS:
        sweep.solve_sweep_step(args[0], mpc, *args[1:], solver=solver)   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        rows[solver] = sweep.solve_sweep_step(args[0], mpc, *args[1:], solver=solver).cpu()
        launches[solver] = {k: v for k, v in kernel_launches().items() if v}
    torch.save(rows, os.path.join(outdir, f"solve_rank{rank}.pt"))
    print(json.dumps({"worker": "solve", "rank": rank, "backend": backend, "device": str(dev),
                      "launches": launches}), flush=True)
    torch.distributed.destroy_process_group()


def worker_sweep(argv):
    """13b/13c, one rank: the port's sweep entry point, its checkpoint saves
    timed, the kernel launches of its run counted."""
    from pympc_quadruped_tpu_torch.examples import sweep as entry
    from pympc_quadruped_tpu_torch.parallel import checkpoint

    Ckpt = checkpoint.SweepCheckpointer
    saves, writes = [], []

    def timed(fn, into):
        def call(*a, **k):
            t0 = time.perf_counter()
            fn(*a, **k)
            into.append((time.perf_counter() - t0) * 1e3)
        return call

    Ckpt.save, Ckpt._write = timed(Ckpt.save, saves), timed(Ckpt._write, writes)
    reset_launches()
    entry.main(argv)
    print(json.dumps({"worker": "sweep", "rank": int(os.environ["RANK"]),
                      "launches": kernel_launches(), "save_ms": saves, "write_ms": writes}),
          flush=True)


def worker_nccl(port):
    """13d: one NCCL rank (world size 1) through ``init_distributed``, the
    sweep's reductions against the same reductions with no group, and a
    short ``rollout_sweep`` over the group."""
    from pympc_quadruped_tpu_torch.parallel import launch, mesh as mesh_lib

    backend = launch.init_distributed(f"localhost:{port}", 1, 0)
    mesh = launch.global_data_mesh()
    local = mesh_lib.DataMesh(None, 0, 1, mesh.device)
    x = torch.randn((500, 4096), generator=torch.Generator(device=mesh.device).manual_seed(5),
                    device=mesh.device)
    reductions = lambda m: (mesh_lib.global_mean({"x": x, "alive": x > 0}, m),
                            mesh_lib.global_max(x, m), mesh_lib.global_sum(x[:, :8], m))
    differ = differing_leaves(reductions(mesh), reductions(local))
    B, ticks = 512, 200
    robot = tree.tile(aliengo(device=mesh.device), B)
    gait, cmd, _ = sweep.mixed_gait_batch(SH_GAITS, B, mesh.device)
    reset_launches()
    _, summary = sweep.rollout_sweep(robot, default_mpc_params(SH_H, device=mesh.device), gait,
                                     cmd, ticks, mesh=mesh)
    print(json.dumps({"worker": "nccl", "backend": backend, "size": mesh.size, "B": B,
                      "ticks": ticks,
                      "reductions_differ": differ, "launches": kernel_launches(),
                      "summary": {k: float(v) for k, v in summary.items()}}), flush=True)
    torch.distributed.destroy_process_group()


def sweep_report(out: str) -> dict:
    """The entry point's printed lines: backend, chunks, ticks/s, resume,
    the divergence events and the per-gait lines."""
    first = next(l for l in out.splitlines() if l.startswith("devices="))
    rep = {"backend": first.split("backend=")[1].split()[0], "gaits": {}, "resumed": None}
    for line in out.splitlines():
        s = line.strip()
        if s.startswith("chunks="):
            rep["chunks"] = s.split()[0].split("=")[1]
            rep["ticks_per_s"] = float(s.split("ticks/s=")[1].replace(",", ""))
        elif s.startswith("resuming at chunk"):
            rep["resumed"] = s
        elif s.startswith("divergence_events:"):
            rep["divergence_max"] = max(float(w.split("=")[1]) for w in s.split()[1:])
        elif s.startswith("gait "):
            name = s.split()[1].rstrip(":")
            rep["gaits"][name] = {w.split("=")[0]: float(w.split("=")[1]) for w in s.split()[2:]}
    return rep


def riccati_vs_plain_h10(robot, mpc, inputs, B):
    """13a's Riccati kernel against its plain version on the first ``B``
    rows of 13a's inputs (h=10): phase 2's max|dU| and first-step fz bars."""
    robot = tree.tree_map(lambda a: a[:B], robot)
    x_t, yaw, feet, X_ref, table = (a[:B] for a in inputs)
    Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
    U_k, U_p = (riccati.solve_batch(Ad, Bd, x_t, X_ref, table, robot.fz_max, mpc, backend=b)
                .reshape(B, mpc.horizon, 12) for b in ("cuda", "torch"))
    fz_k, fz_p = U_k[:, 0, 2::3], U_p[:, 0, 2::3]
    fz_rel = float(((fz_k - fz_p).abs() / fz_p.abs().clamp(min=20.0)).max())
    u_err = float((U_k - U_p).abs().max())
    check(bool(torch.isfinite(U_k).all()), f"13a riccati B={B}: non-finite kernel output")
    return u_err, fz_rel


def admm_fast_stages(robot, mpc, inputs, half):
    """Where ``admm_fast``'s solve of the first ``half`` rows parts from
    the same rows of the whole batch's solve: each stage of the split path
    runs at both batch sizes on the same input (the whole batch's previous
    stage), and its output rows are compared.  ``(stage, differing
    elements, elements, max abs difference)`` per stage."""
    x_t, yaw, feet, X_ref, table = inputs
    cfg = admm_fast.AdmmFastConfig()
    P0 = admm_fast.cone_pattern(mpc.friction_coef, mpc.horizon).to(x_t)
    rows = lambda t: t[:half].contiguous()
    report = []

    def stage(name, fn, *args):
        full = fn(*args)
        part = fn(*(tree.tree_map(rows, a) for a in args))
        full_t, part_t = (o if isinstance(o, tuple) else (o,) for o in (full, part))
        d = [(rows(a) - b).abs() for a, b in zip(full_t, part_t)]
        report.append((name, sum(int((x > 0).sum()) for x in d), sum(x.numel() for x in d),
                       max(float(x.max()) for x in d)))
        return full

    Ad, Bd = stage("srb.discretize", lambda rb, yw, ft: srb.discretize(
        *srb.state_space(rb, yw, ft), mpc.dt_predict), robot, yaw, feet)
    Sx, Su = stage("condense.rollout_matrices",
                   lambda a, b: condense.rollout_matrices(a, b, mpc.horizon), Ad, Bd)
    H, g = stage("condense.qp_cost", lambda *a: condense.qp_cost(*a, mpc), Sx, Su, x_t, X_ref)
    H, g = stage("cones.mask_cost", cones.mask_cost, H, g, cones.variable_mask(table, mpc))
    ops = stage("admm_fast.setup", lambda *a: tuple(admm_fast.setup(*a, mpc, cfg, invert=False)),
                H, g, table, robot.fz_max)
    Kinv = stage("admm_cuda.invert_spd",
                 lambda K: admm_cuda.invert_spd(K, cfg.newton_schulz_iters), ops[0])
    stage("admm_cuda.iterate",
          lambda *o: admm_cuda.iterate(admm_fast.AdmmOperands(*o), P0, cfg), Kinv, *ops[1:])
    return report


def phase_sharded(dev, card):
    """Phase 13: 13a ``solve_sweep_step`` over 2 gloo ranks on the one card
    against the unsharded solve here, with 13d (one NCCL rank) alongside;
    13b the sweep entry point over 2 ranks; 13c the same stopped after one
    chunk and resumed, bitwise 13b's final checkpoint."""
    t_phase = time.perf_counter()
    here = os.path.abspath(__file__)
    work = os.path.join(os.path.dirname(here), "chiprun_out", "phase13")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    py = [sys.executable, here, "--worker"]

    # 13a + 13d: started together.
    port, port_nccl = launch.free_port(), launch.free_port()
    jobs = [(py + ["solve", str(r), str(SH_RANKS), str(port), work],
             launch.launcher_env(port, r, SH_RANKS)) for r in range(SH_RANKS)]
    jobs.append((py + ["nccl", str(port_nccl)], launch.launcher_env(port_nccl, 0, 1)))
    t0 = time.perf_counter()
    outs = launch.run_ranks(jobs, timeout=400)
    wall_a = time.perf_counter() - t0
    solve = [worker_json(o, "solve") for o in outs[:SH_RANKS]]
    nccl = worker_json(outs[SH_RANKS], "nccl")
    rows = [torch.load(os.path.join(work, f"solve_rank{r}.pt"), weights_only=True)
            for r in range(SH_RANKS)]
    robot = tree.tile(aliengo(device=dev), SH_B)
    inputs = sweep_solve_inputs(SH_B, SH_H, dev)
    mpc = default_mpc_params(SH_H, device=dev)
    res_a = {}
    for solver in SH_SOLVERS:
        U_ref = sweep.solve_sweep_step(robot, mpc, *inputs, solver=solver).cpu()
        U = torch.cat([r[solver] for r in rows])
        d = (U - U_ref).abs()
        support = (U.reshape(SH_B, 4, 3)[..., 2].sum(-1)
                   - U_ref.reshape(SH_B, 4, 3)[..., 2].sum(-1)).abs().max()
        mean_err = abs(float(U.abs().mean()) - float(U_ref.abs().mean()))
        res_a[solver] = dict(max_abs_err=float(d.max()), differing=int((d > 0).sum()),
                             elements=d.numel(), support_err=float(support), mean_err=mean_err,
                             launches=[s["launches"][solver] for s in solve])
        print(f"phase 13a: solve_sweep_step solver={solver} over {SH_RANKS} gloo ranks on one "
              f"card (backends {[s['backend'] for s in solve]}), B={SH_B} global, h={SH_H}, "
              f"against the unsharded solve: max|dU| {float(d.max()):.3e} N with "
              f"{int((d > 0).sum())} of {d.numel()} elements differing (tests/test_sharding.py:37 "
              f"bar {SH_EXACT_BAR} {'met' if float(d.max()) <= SH_EXACT_BAR else 'not met'}; "
              f"this solver's bar {SH_SOLVER_BAR[solver]}), "
              f"support {float(support):.3e} N (bar {SH_SUPPORT_BAR}), mean|U| {mean_err:.3e} "
              f"(bar {SH_MEAN_BAR}); each rank's launches {res_a[solver]['launches']} [{card}]",
              flush=True)
        check(float(d.max()) <= SH_SOLVER_BAR[solver] and float(support) < SH_SUPPORT_BAR
              and mean_err < SH_MEAN_BAR, f"phase 13a: sharded {solver} outside the bars")
        on_path = ("riccati_admm",) if solver == "riccati" else ("invert_spd", "iterate")
        check(all(s["launches"][solver].get(k, 0) > 0 for s in solve for k in on_path),
              f"phase 13a: a rank did not launch {on_path}")
    check(all(s["backend"] == "gloo" for s in solve), "phase 13a: two ranks on one card not gloo")
    # The Riccati kernel at 13a's h=10, at the whole and the per-rank batch,
    # against its plain version (phase 2 holds it at h=16 only).
    for B in (SH_B, SH_B // SH_RANKS):
        u_err, fz_rel = riccati_vs_plain_h10(robot, mpc, inputs, B)
        res_a["riccati"][f"kernel_vs_plain_B{B}"] = dict(max_abs_err=u_err, fz_rel=fz_rel)
        print(f"phase 13a: riccati_admm kernel against its plain version at h={SH_H}, B={B}, "
              f"13a's inputs: max|dU|={u_err:.3e} N (bar {U_ABS_BAR}), first-step fz "
              f"rel={fz_rel:.3e} (bar {FZ_REL_BAR}) [{card}]", flush=True)
        check(u_err < U_ABS_BAR and fz_rel < FZ_REL_BAR,
              f"phase 13a: the Riccati kernel disagrees with the plain version at h={SH_H} B={B}")
    # Where admm_fast's rows of a rank part from the unsharded rows.
    stages = admm_fast_stages(robot, mpc, inputs, SH_B // SH_RANKS)
    res_a["admm_fast"]["stages"] = stages
    print(f"phase 13a: admm_fast, each stage at B={SH_B // SH_RANKS} against B={SH_B}'s rows on "
          "the same input (differing elements of all, max abs): "
          + "; ".join(f"{n} {k} of {t}, {m:.3e}" for n, k, t, m in stages) + f" [{card}]",
          flush=True)
    print(f"phase 13d: one rank through init_distributed: backend {nccl['backend']}, world size "
          f"{nccl['size']}; the sweep's reductions over the group against no group: "
          f"{nccl['reductions_differ'] or 'bitwise equal'}; rollout_sweep B={nccl['B']} "
          f"h={SH_H} {nccl['ticks']} ticks over the group: {nccl['summary']}, launches "
          f"{ {k: v for k, v in nccl['launches'].items() if v} } ({wall_a:.1f} s for 13a and "
          f"13d together) [{card}]", flush=True)
    check(nccl["backend"] == "nccl" and nccl["size"] == 1 and not nccl["reductions_differ"]
          and nccl["summary"]["survival_frac"] == 1.0, "phase 13d: the NCCL rank failed")

    # 13b: the entry point over 2 ranks, straight through.
    entry_args = ["--batch", str(SH_B), "--seconds", str(SH_SECONDS), "--chunk-ticks",
                  str(SH_CHUNK), "--gaits", ",".join(SH_GAITS), "--seed", "0"]
    n_chunks = int(SH_SECONDS * 1000) // SH_CHUNK

    def entry(ckpt_dir, extra=()):
        port = launch.free_port()
        outs = launch.run_ranks([(py + ["sweep", "--ckpt-dir", ckpt_dir, *entry_args, *extra],
                                  launch.launcher_env(port, r, SH_RANKS))
                                 for r in range(SH_RANKS)], timeout=600)
        return [sweep_report(o) for o in outs], [worker_json(o, "sweep") for o in outs]

    straight, resumed = os.path.join(work, "straight"), os.path.join(work, "resumed")
    t0 = time.perf_counter()
    reps, workers = entry(straight)
    wall_b = time.perf_counter() - t0
    step_dir = os.path.join(straight, str(n_chunks))
    ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir)
                     if f.endswith(".pt"))
    save_ms = [float(np.median(w["save_ms"])) for w in workers]
    write_ms = [float(np.median(w["write_ms"])) for w in workers]
    for r, (rep, w) in enumerate(zip(reps, workers)):
        launches = {k: v for k, v in w["launches"].items() if v}
        print(f"phase 13b: rank {r}: backend {rep['backend']}, chunks {rep['chunks']}, "
              f"ticks/s {rep['ticks_per_s']:,.0f} (global batch over the wall; two ranks share "
              f"one card, so this is no scaling figure), kernel launches {launches} [{card}]",
              flush=True)
        check(rep["chunks"] == f"{n_chunks}/{n_chunks}" and rep["backend"] == "gloo",
              f"phase 13b: rank {r} did not run its chunks over gloo")
        check(w["launches"]["invert_spd"] > 0 and w["launches"]["iterate"] > 0,
              f"phase 13b: rank {r} launched no condensed kernel")
        check(rep["divergence_max"] == 0.0, f"phase 13b: rank {r} saw divergence events")
    check(reps[0]["gaits"] == reps[1]["gaits"], "phase 13b: the ranks' per-gait lines differ")
    ticks = SH_SECONDS * 1e3
    for name in SH_GAITS:
        s = reps[0]["gaits"][name]
        expect = sweep.GAIT_SWEEP_VX[name] * ticks * 1e-3
        print(f"phase 13b: sweep entry point Aliengo h={SH_H} B={SH_B} over {SH_RANKS} ranks, "
              f"{n_chunks} x {SH_CHUNK} ticks ({wall_b:.1f} s with start-up) {name}: n "
              f"{int(s['n'])}, survival {s['survival']:.4f} (bar 1.0), mean_vel_err "
              f"{s['mean_vel_err']:.4f} m/s (bar 0.3), fwd_disp {s['fwd_disp_m']:.2f} m (bar "
              f"{0.6 * expect:.2f}) [{card}]", flush=True)
        check(s["survival"] == 1.0 and s["mean_vel_err"] < 0.3
              and s["fwd_disp_m"] > 0.6 * expect, f"phase 13b: {name} outside phase 10's bars")
    print(f"phase 13b: checkpoint per step at B={SH_B}: {ckpt_bytes} bytes over {SH_RANKS} rank "
          f"files; save (host copy, barriers, prune) median {save_ms} ms per rank, background "
          f"write median {write_ms} ms per rank [{card}]", flush=True)

    # 13c: stopped after one chunk, resumed by fresh processes.
    t0 = time.perf_counter()
    entry(resumed, ["--stop-after-chunks", "1"])
    reps_c, _ = entry(resumed)
    wall_c = time.perf_counter() - t0
    check(all(r["resumed"] == f"resuming at chunk 1 (tick {SH_CHUNK})" for r in reps_c),
          "phase 13c: the second run did not resume at chunk 1")
    a, b = checkpoint.read_step(straight, n_chunks)[1], checkpoint.read_step(resumed, n_chunks)[1]
    diffs = [", ".join(differing_leaves(x, y)) for x, y in zip(a, b)]
    leaves = sum(len(x) for x in a)
    print(f"phase 13c: stopped after chunk 1, resumed in fresh processes: final checkpoint (step "
          f"{n_chunks}, {leaves} leaves over {SH_RANKS} ranks) against 13b's: "
          f"{'; '.join(d for d in diffs if d) or 'bitwise equal'} ({wall_c:.1f} s) [{card}]",
          flush=True)
    check(not any(diffs), "phase 13c: the resumed sweep's final checkpoint differs")

    # The cost of drawing the global batch's sensor noise on each rank.
    draws = lambda rows: srb_env.sensor_draws(0, 0, SH_CHUNK, SH_B // SH_RANKS, dev, rows)
    ms_local = cuda_ms(lambda: draws(None), warmup=1, reps=3)
    ms_global = cuda_ms(lambda: draws((SH_B // SH_RANKS, SH_B)), warmup=1, reps=3)
    shutil.rmtree(work)     # the checkpoints (~26 MB); kept when a check fails
    wall = time.perf_counter() - t_phase
    print(f"phase 13: a rank's sensor noise for one {SH_CHUNK}-tick chunk at B={SH_B} over "
          f"{SH_RANKS} ranks: {ms_global:.3f} ms drawing the global rows and keeping its own, "
          f"{ms_local:.3f} ms drawing only its count; phase 13 took {wall:.1f} s [{card}]",
          flush=True)
    return dict(solve=res_a, ticks_per_s=[r["ticks_per_s"] for r in reps],
                backends=[r["backend"] for r in reps], ckpt_bytes=ckpt_bytes,
                save_ms=save_ms, write_ms=write_ms,
                launches={"13b": [w["launches"] for w in workers]},
                noise_ms={"global_rows": ms_global, "own_rows": ms_local},
                nccl=nccl, wall_s=wall)


# ---------------------------------------------------------------------------
# Phase 14: the single-robot adapter, the mixed-gait grid, SE(3) and the
# Toeplitz condensing, NaN isolation
# ---------------------------------------------------------------------------

#: 14a: the MuJoCo example's defaults (B=1, h=10, TROTTING10 at 1.2 m/s,
#: ``admm_fast``), phase 11b's configuration, for SR_TICKS ticks on the
#: full-order plant; the first SR_CHECKED_SOLVES solves are held against the
#: plain version.  The reference's limits: 20 ms a solve, 1 ms a tick
#: (BASELINE.md:13-14).
SR_TICKS, SR_CHECKED_SOLVES = 2000, 5
SR_SOLVE_LIMIT_MS, SR_TICK_LIMIT_MS = 20.0, 1.0
#: 14b's bars: the JAX package's per-gait share on the same 4096 scenarios
#: (tools/fullorder_reference_share.py --part 14b, its line in
#: tools/fullorder_reference_share.jsonl) less one point, as phase 11.
BV_REFERENCE_SHARE = {"trotting10": 1.0, "pacing10": 1.0, "bounding8": 1.0}
#: 14c: the SE(3)/PoE functions on the card against the CPU (f32 sin/cos
#: and products differ by a few ulp at O(1) values), and the PoE leg FK
#: against the closed-form one.
SE3_BAR = 1e-5
#: 14d: the scenario made non-finite.
NAN_ROW = 1234


def obs_to_host(obs) -> dict:
    """A B=1 ``RobotObs`` on the card as the MuJoCo example's host dict."""
    flat = torch.cat([obs.pos_base, obs.lin_vel_base, obs.quat_base, obs.ang_vel_base,
                      obs.q, obs.qdot], dim=-1)[0].double().cpu().numpy()
    return dict(zip(OBS_KEYS, np.split(flat, np.cumsum([3, 3, 4, 3, 12]))))


class QpRecorder:
    """Keeps the first ``n`` condensed QPs the controller builds and solves
    (the inputs of ``refmpc.build_qp``, its outputs, the solver's config,
    warm start and U), by wrapping the two module functions while open."""

    def __init__(self, n: int):
        self.n, self.qps = n, []

    def __enter__(self):
        self.build, self.solve = refmpc.build_qp, admm_fast.solve_batch

        def build_qp(robot, mpc, x_t, yaw, feet, X, table):
            out = self.build(robot, mpc, x_t, yaw, feet, X, table)
            if len(self.qps) < self.n:
                self.qps.append(dict(robot=robot, mpc=mpc, x_t=x_t.clone(), yaw=yaw.clone(),
                                     feet=feet.clone(), table=table.clone(),
                                     H=out[0].clone(), g=out[1].clone(), mv=out[2].clone()))
            return out

        def solve_batch(H, g, table, fz_max, mpc, cfg, warm=None, return_duals=False):
            res = self.solve(H, g, table, fz_max, mpc, cfg, warm=warm, return_duals=return_duals)
            if self.qps and "U" not in self.qps[-1]:
                self.qps[-1].update(
                    cfg=cfg, warm=None if warm is None else tuple(w.clone() for w in warm),
                    U=(res[0] if return_duals else res).clone())
            return res

        refmpc.build_qp, admm_fast.solve_batch = build_qp, solve_batch
        return self

    def __exit__(self, *exc):
        refmpc.build_qp, admm_fast.solve_batch = self.build, self.solve
        return False


def recorded_invariants(qps) -> dict:
    """Phase 5's QP invariants of each recorded kernel solve against the
    plain version on the same CUDA tensors, concatenated over the solves."""
    rows = []
    for qp in qps:
        mpc, robot = qp["mpc"], qp["robot"]
        Ad, Bd = srb.discretize(*srb.state_space(robot, qp["yaw"], qp["feet"]), mpc.dt_predict)
        Sx, Su = condense.rollout_matrices(Ad, Bd, mpc.horizon)
        p = CondensedProblem(mpc, robot, qp["H"], qp["g"], qp["mv"], qp["table"], qp["warm"],
                             (Sx @ qp["x_t"][..., None])[..., 0], Su)
        U_p = admm_fast.solve_batch(qp["H"], qp["g"], qp["table"], robot.fz_max, mpc, qp["cfg"],
                                    backend="jnp", warm=qp["warm"])
        rows.append(qp_invariants(p, qp["U"], U_p))
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def single_robot_loop(dev, step, ticks: int, part: str = "11b") -> dict:
    """Drive the MuJoCo example's controller adapter ``step(obs, tick)`` at
    B=1 on ``fullorder.physics_step`` at B=1 through host numpy each tick,
    as it drives MuJoCo, in phase ``part``'s configuration (FO_PARTS) for
    ``ticks`` ticks: its band over the last FO_TAIL ticks, divergence, and
    the controller's and the plant's tick times."""
    p = FO_PARTS[part]
    robot = tree.tile(aliengo(device=dev), 1)
    model = tree.tile(fullorder.rbd_model(aliengo(device=dev), mjcf.aliengo_spec()), 1)
    cp = fullorder.ContactParams.default(dev)
    state = fullorder.default_init_state(robot, cp.foot_radius)
    dt = default_mpc_params(p["horizon"], device=dev).dt_control
    vel_des = Command.trot_forward(p["vx"], device=dev).vel_base_des
    rows, tick_ms, plant_ms = [], [], []
    t_run = time.perf_counter()
    for tick in range(ticks):
        obs = obs_to_host(fullorder.observe(robot, state))
        t0 = time.perf_counter()
        torques, forces = step(obs, tick)
        t1 = time.perf_counter()
        tau = torch.from_numpy(np.asarray(torques, np.float32)).to(dev)[None]
        state, _ = fullorder.physics_step(model, robot, cp, state, tau, dt)
        R = lie.quat_to_rotmat(state.quat)
        v_world = (R @ state.u[:, 3:6, None])[..., 0]
        v_des = (R @ vel_des[:, None])[..., 0]
        rows.append(torch.stack([
            torch.linalg.vector_norm(v_world[:, :2] - v_des[:, :2], dim=-1)[0],
            state.pos[0, 2], R[0, 2, 2],
            fullorder._diverged(state, torch.zeros_like(state.pos[:, 2]))[0].float()]))
        torch.cuda.synchronize()
        tick_ms.append((t1 - t0) * 1e3)
        plant_ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t_run
    m = torch.stack(rows).cpu()
    metrics = {"vel_err": m[:, :1], "height": m[:, 1:2], "upright": m[:, 2:3]}
    tail = lambda key: float(metrics[key][-FO_TAIL:].mean())
    # Tick 0 (the first solve) carries one-time set-up; it is reported apart.
    ms = np.array(tick_ms)
    solve = ms[[i for i in range(1, ticks) if i % PERIOD == 0]]
    other = ms[[i for i in range(ticks) if i % PERIOD]]
    q = lambda a, pct: float(np.percentile(a, pct))
    return dict(
        part=part, ok=bool(fullorder_in_band(metrics, state.pos[:, 0].cpu(), p["band"])[0]),
        diverged=bool(m[:, 3].any()), wall_s=wall, height=tail("height"),
        vel_err=tail("vel_err"), upright=float(metrics["upright"][-FO_TAIL:].min()),
        final_x=float(state.pos[0, 0]), first_tick_ms=tick_ms[0],
        solve_tick_ms={"p50": q(solve, 50), "p99": q(solve, 99)},
        other_tick_ms={"p50": q(other, 50), "p99": q(other, 99)},
        plant_ms_p50=q(np.array(plant_ms), 50))


def band_report(r: dict) -> str:
    return (f"in phase {r['part']}'s band {r['ok']} (over the last {FO_TAIL} ticks height "
            f"{r['height']:.3f} m, vel_err {r['vel_err']:.3f} m/s, least upright "
            f"{r['upright']:.3f}; final x {r['final_x']:.3f} m), diverged {r['diverged']}")


def phase_single_robot(dev, card):
    """14a: ``make_torch_controller`` (the MuJoCo example's adapter) at B=1
    on the card, driving ``fullorder.physics_step`` at B=1 through host
    numpy each tick, as it drives MuJoCo."""
    p = FO_PARTS["11b"]
    step = make_torch_controller(p["horizon"], "aliengo", p["vx"], 0.0, p["gait"], device=dev)
    torch.cuda.synchronize()
    reset_launches()
    with QpRecorder(SR_CHECKED_SOLVES) as rec:
        r = single_robot_loop(dev, step, SR_TICKS)
    launches = kernel_launches()
    n_solves = SR_TICKS // PERIOD
    for name, count in launches.items():
        want = n_solves if name in ("invert_spd", "iterate", "condense") else 0
        check(count == want, f"phase 14a: kernel {name} launched {count} times, expected {want}")
    ok, diverged, solve, other = r["ok"], r["diverged"], r["solve_tick_ms"], r["other_tick_ms"]
    print(f"phase 14a: make_torch_controller Aliengo h={p['horizon']} {p['gait']} {p['vx']} m/s "
          f"admm_fast B=1 on fullorder.physics_step B=1, torques through host numpy, "
          f"{SR_TICKS} ticks in {r['wall_s']:.1f} s: {band_report(r)}; kernel launches "
          f"invert_spd {launches['invert_spd']}, iterate {launches['iterate']} ({n_solves} "
          f"solves)", flush=True)
    print(f"phase 14a: controller tick, synchronised, host in and out: solve ticks p50 "
          f"{solve['p50']:.3f} / p99 {solve['p99']:.3f} ms (limit {SR_SOLVE_LIMIT_MS:g} ms a "
          f"solve; the first, set-up included, {r['first_tick_ms']:.1f} ms), other ticks p50 "
          f"{other['p50']:.3f} / p99 {other['p99']:.3f} ms (limit {SR_TICK_LIMIT_MS:g} ms a "
          f"tick); the plant (physics_step B=1 and the metric rows) p50 "
          f"{r['plant_ms_p50']:.3f} ms; not gated [{card}]", flush=True)
    check(ok and not diverged, "phase 14a: the single robot left phase 11b's band")

    check(len(rec.qps) == SR_CHECKED_SOLVES and all("U" in qp for qp in rec.qps),
          "phase 14a: the recorder missed a solve")
    inv = recorded_invariants(rec.qps)
    pm = {k: p99_max(v) for k, v in inv.items()}
    fz_max = float(aliengo(device=dev).fz_max)
    print(f"phase 14a: the first {SR_CHECKED_SOLVES} B=1 solves (invert_spd + iterate) against the "
          f"plain version on the same CUDA tensors (p99 / max): cost excess "
          f"{pm['excess'][0]:.3e} / {pm['excess'][1]:.3e} (bar {COST_BAR}), cone violation "
          f"{pm['cone'][0]:.3e} / {pm['cone'][1]:.3e} N (bar {CONE_SHARE * fz_max:g}), predicted "
          f"CoM {pm['pos'][0]:.2e} / {pm['pos'][1]:.2e} m, {pm['vel'][0]:.2e} / "
          f"{pm['vel'][1]:.2e} m/s (bars {TRAJ_POS_BAR}, {TRAJ_VEL_BAR}; max {WORST_FACTOR:g}x); "
          f"first-step fz rel {pm['fz'][1]:.3e}", flush=True)
    check(invariants_ok(inv, fz_max), "phase 14a: a B=1 solve disagrees with the plain version")
    return launches, dict(
        wall_s=r["wall_s"], in_band=ok, max_excess=pm["excess"][1], solve_tick_ms=solve,
        other_tick_ms=other, first_tick_ms=r["first_tick_ms"], plant_ms_p50=r["plant_ms_p50"])


def phase_batch_viz(dev, card):
    """14b: ``examples/batch_viz.record_batch`` at BV_B scenarios: one
    capture (and no traced one, as no profiler records), BV_FRAMES frames,
    the per-gait share in band, ticks/s."""
    torch.cuda.synchronize()
    reset_launches()
    graph_loop.CAPTURES = 0
    traced0 = traced_captures()
    t0 = time.perf_counter()
    frames, m = record_batch(BV_B, BV_SECONDS, BV_FRAME_TICKS, BV_VX, device=dev,
                             return_metrics=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, captures = kernel_launches(), graph_loop.CAPTURES
    traced = traced_captures() - traced0
    n_solves = BV_TICKS // PERIOD
    for name, count in launches.items():
        want = loop_launches(name, ("invert_spd", "iterate", "condense"), n_solves)
        check(count == want, f"phase 14b: kernel {name} launched {count} times, expected {want}")
    check(captures == 1, f"phase 14b: {captures} graph captures, expected one")
    check(traced == 0, f"phase 14b: {traced} traced graph captures outside a profiler")
    check(len(frames) == BV_FRAMES and frames[-1][2].shape == (BV_B, 12),
          f"phase 14b: {len(frames)} frames, expected {BV_FRAMES}")
    ok = batch_viz_in_band(m)
    shares = per_gait_share(ok)
    bars = {g: min(BAND_SHARE, BV_REFERENCE_SHARE[g] - 0.01) for g in BV_GAITS}
    tps = BV_B * BV_TICKS / wall
    per_gait = ", ".join(f"{g} {shares[g]:.4f} (bar {bars[g]:.4f})" for g in BV_GAITS)
    print(f"phase 14b: record_batch Aliengo h=10 {'/'.join(BV_GAITS)} (i % 3), 0.6-1.0 x "
          f"{BV_VX} m/s, B={BV_B}, {BV_FRAMES} frames of {BV_FRAME_TICKS} ticks ({BV_TICKS} "
          f"ticks) in {wall:.1f} s (capture and host copies included): {tps:.0f} ticks/s; "
          f"{captures} graph capture, {traced} traced; kernel launches invert_spd "
          f"{launches['invert_spd']}, iterate {launches['iterate']}; in band (no divergence, mean height over the last "
          f"{FO_TAIL} ticks in {BV_HEIGHT_BAND}): {per_gait}; diverged "
          f"{int(m['diverged'].any(dim=0).sum())} [{card}]", flush=True)
    check(all(shares[g] >= bars[g] for g in BV_GAITS), "phase 14b: a gait below its bar")
    return launches, dict(wall_s=wall, ticks_per_s=tps, captures=captures, frames=len(frames),
                          share=shares, bar=bars)


def leg_screws(robot, leg: int):
    """(home (4,4), screws (3,6)) of one leg's hip, thigh and knee joints in
    the base frame, from the robot's geometry (tests/test_lie.py:165), on
    the robot's device."""
    f64 = dict(dtype=torch.float64, device=robot.mass.device)
    hip = robot.hip_offset[leg].double()
    l1, l2, l3 = robot.hip_len[leg].double(), robot.l_thigh.double(), robot.l_calf.double()
    ex = torch.tensor([1.0, 0.0, 0.0], **f64)
    ey, ez = ex.roll(1), ex.roll(2)
    p_thigh = hip + l1 * ey
    p_knee = p_thigh - l2 * ez
    screws = torch.stack([lie.screw_axis(ex, hip), lie.screw_axis(ey, p_thigh),
                          lie.screw_axis(ey, p_knee)])
    home = torch.eye(4, **f64)
    home[:3, 3] = p_knee - l3 * ez
    return home.float(), screws.float()


def se3_inputs(n: int, seed: int) -> dict:
    """Seeded float32 CPU inputs of each SE(3)/PoE function, n of each; the
    first 64 screws are pure translations (exp_se3's small-angle branch)."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    quat = rng.normal(size=(n, 4))
    R = lie.quat_to_rotmat(T(quat / np.linalg.norm(quat, axis=-1, keepdims=True)))
    p = T(rng.normal(size=(n, 3)))
    Tr = lie.rp_to_se3(R, p)
    S = rng.normal(size=(n, 6))
    S[:64, :3] = 0.0
    return {"exp_so3": (T(axis), T(rng.uniform(-3, 3, n))), "rp_to_se3": (R, p),
            "inv_se3": (Tr,), "adjoint_rp": (R, p), "adjoint_se3": (Tr,),
            "screw_axis": (T(axis), p), "twist_to_se3": (T(rng.normal(size=(n, 6))),),
            "exp_se3": (T(S), T(rng.uniform(-1.5, 1.5, n))),
            "fk_open_chain": (Tr, T(0.7 * rng.normal(size=(n, 3, 6))),
                              T(rng.uniform(-1.5, 1.5, (n, 3))))}


def phase_se3_toeplitz(dev, card):
    """14c (no kernel): the SE(3)/PoE functions on the card against the CPU,
    the PoE leg FK against ``kin``, and ``qp_cost_toeplitz`` against the
    Gram condensing at B=4096, h=16 with both times."""
    n = B_MAIN
    errs = {}
    for name, args in se3_inputs(n, 14).items():
        fn = getattr(lie, name)
        errs[name] = float((fn(*(a.to(dev) for a in args)).cpu() - fn(*args)).abs().max())
    robot = aliengo(device=dev)
    q = torch.tensor(np.random.default_rng(15).uniform(-1.0, 1.0, (n, 4, 3)),
                     dtype=torch.float32, device=dev)
    p_ref, _ = kin.leg_forward_kinematics(robot, q)
    fk_err = 0.0
    for leg in range(4):
        home, screws = leg_screws(robot, leg)
        T = lie.fk_open_chain(home.expand(n, 4, 4), screws.expand(n, 3, 6), q[:, leg])
        fk_err = max(fk_err, float((T[:, :3, 3] - p_ref[:, leg]).abs().max()))
    worst = max(errs, key=errs.get)
    print(f"phase 14c: the nine SE(3)/PoE functions at {n} seeded inputs, card against CPU: "
          f"max |d| {errs[worst]:.2e} ({worst}; bar {SE3_BAR:g}); fk_open_chain against "
          f"kin.leg_forward_kinematics on the card, 4 legs x {n}: max |dp| {fk_err:.2e} m "
          f"(bar {SE3_BAR:g})", flush=True)
    check(max(errs.values()) < SE3_BAR and fk_err < SE3_BAR, "phase 14c: SE(3) outside the bar")

    mpc, robot_b, Ad, Bd, x_t, X_ref, table, _ = random_problem(B_MAIN, HORIZON, 16, dev)
    gram = lambda: condense.condense(Ad, Bd, x_t, X_ref, mpc)
    toeplitz = lambda: condense.qp_cost_toeplitz(Ad, Bd, x_t, X_ref, mpc)
    (H1, g1), (H2, g2) = gram(), toeplitz()
    dH = float((H2.double() - H1.double()).abs().max() / H1.double().abs().max())
    dg = float((g2.double() - g1.double()).abs().max() / (g1.double().abs().max() + 1.0))
    sym = bool(torch.equal(H2, H2.transpose(-1, -2)))
    ms_gram, ms_toep = cuda_ms(gram), cuda_ms(toeplitz)
    Sx, Su = condense.rollout_matrices(Ad, Bd, HORIZON)
    ms_qp_cost = cuda_ms(lambda: condense.qp_cost(Sx, Su, x_t, X_ref.reshape(B_MAIN, -1), mpc))
    cfg = admm_fast.AdmmFastConfig.inloop()
    solve = lambda Hg: admm_fast.solve_batch(Hg[0], Hg[1], table, robot_b.fz_max, mpc, cfg)
    ms_gram_solve, ms_toep_solve = cuda_ms(lambda: solve(gram())), cuda_ms(lambda: solve(toeplitz()))
    print(f"phase 14c: qp_cost_toeplitz against the Gram condensing at B={B_MAIN}, h={HORIZON}: "
          f"max|dH|/max|H| {dH:.2e}, max|dg|/(max|g|+1) {dg:.2e} (bars 1e-6, "
          f"tests/test_condense.py:103), H exactly symmetric {sym}; from (Ad, Bd): Toeplitz "
          f"{ms_toep:.3f} ms, rollout_matrices + qp_cost {ms_gram:.3f} ms (qp_cost alone "
          f"{ms_qp_cost:.3f}); composed with the split solve (inloop, {cfg.iterations} sweeps): "
          f"{ms_toep_solve:.3f} against {ms_gram_solve:.3f} ms [{card}]", flush=True)
    check(dH < 1e-6 and dg < 1e-6 and sym, "phase 14c: the Toeplitz condensing outside the bars")
    return dict(se3_max_err=errs[worst], fk_max_err=fk_err, toeplitz_dH=dH, toeplitz_dg=dg,
                toeplitz_ms=ms_toep, gram_ms=ms_gram, qp_cost_ms=ms_qp_cost,
                toeplitz_solve_ms=ms_toep_solve, gram_solve_ms=ms_gram_solve)


def nan_isolation(dev, backend: str, B: int = B_MAIN) -> dict:
    """One solve of a B-scenario batch through ``backend`` (an ``admm_fast``
    backend or ``"riccati"``), with and without scenario NAN_ROW's input
    made NaN (g for the condensed path, x_t for the Riccati path, as a NaN
    observation makes it): how many elements of the other scenarios'
    solutions differ, and whether the poisoned one is non-finite."""
    row = NAN_ROW % B
    if backend == "riccati":
        p = riccati_problem(B, "inloop", dev, seed=17)
        Ad, Bd, x_t, X_ref = p.args[:4]
        bad = x_t.clone()
        bad[row] = float("nan")
        run = lambda x: riccati.solve_batch(Ad, Bd, x, X_ref, p.table, p.robot.fz_max, p.mpc,
                                            p.cfg, backend="cuda")
        clean, poisoned = run(x_t), run(bad)
    else:
        p = condensed_problem(B, 17, dev)
        bad = p.g.clone()
        bad[row] = float("nan")
        cfg = admm_fast.AdmmFastConfig.inloop()
        run = lambda g: admm_fast.solve_batch(p.H, g, p.table, p.robot.fz_max, p.mpc, cfg,
                                              backend=backend, warm=p.warm)
        clean, poisoned = run(p.g), run(bad)
    torch.cuda.synchronize()
    keep = torch.arange(B, device=dev) != row
    return {"others_differ": int((clean[keep] != poisoned[keep]).sum()),
            "others": int(clean[keep].numel()),
            "others_finite": bool(torch.isfinite(poisoned[keep]).all()),
            "poisoned_finite": bool(torch.isfinite(poisoned[row]).all())}


NAN_BACKENDS = ("pallas_split", "pallas_fused", "pallas_full", "riccati")


def phase_nan_isolation(dev, card):
    """14d: a NaN scenario leaves every other scenario of a B=4096 batch
    bitwise unchanged, through each kernel backend."""
    res = {}
    for backend in NAN_BACKENDS:
        r = res[backend] = nan_isolation(dev, backend)
        print(f"phase 14d: {backend} at B={B_MAIN}, h={HORIZON}, scenario {NAN_ROW} NaN: "
              f"{r['others_differ']} of the other scenarios' {r['others']} elements differ "
              f"(bar: bitwise equal), the others finite {r['others_finite']}, the poisoned "
              f"scenario finite {r['poisoned_finite']}", flush=True)
        check(r["others_differ"] == 0 and r["others_finite"],
              f"phase 14d: the NaN scenario reached another scenario through {backend}")
    return res


# ---------------------------------------------------------------------------
# Phase 15: the float64 golden model on the card (oracle/)
# ---------------------------------------------------------------------------

#: 15a's gates: every scenario's certificate (tests/test_cpp_oracle.py:21);
#: the card against the CPU on the first CPU_B scenarios, relative to
#: 1 + |U|; ORACLE_CPP_N scenarios through the C++ oracle, run to
#: solve_qp_kkt's own tolerance ORACLE_TOL, on the f64 cost both certify
#: (two-sided, relative to |q| + 1).  tests/test_cpp_oracle.py:25 holds U to
#: 1e-6 at h=10; at h=16 two certificates near 1e-10 leave U determined only
#: along the reduced Hessian's weak directions (on the CPU, rehearsing at
#: B=64, two of the first 8 scenarios part by 1.9e-5 and 4.9e-6 of
#: (1 + |U|) at costs 1e-13 apart), so U is printed, not gated.  And the
#: oracle's H and g against the port's float64 condensing
#: (``condense.condense_ff`` on float64 ``srb`` discretization), relative
#: to max|H| and max|g|; ``build_qp_ff`` as the parity route runs it
#: discretizes in float32 (``srb.discretize`` on the float32 model), which
#: moves H by ~2.6e-7 of max|H| on the CPU: it is held to CONDENSE_F32_BAR.
ORACLE_KKT_BAR, ORACLE_CPU_BAR, ORACLE_CPP_N, ORACLE_TOL = 1e-7, 1e-8, 8, 1e-10
ORACLE_CPP_COST_BAR = 1e-10
CONDENSE_BAR, CONDENSE_F32_BAR = 1e-9, 1e-6
#: 15b: tests/test_riccati.py:136's h=16 cost-excess bar.  A kernel backend
#: above it at p99 is a finding, printed, not a failure; so is one whose
#: cone violation is above CONE_SHARE fz_max at p99.  The kernel backends'
#: worst scenario is held to phase 5's WORST_FACTOR x CONE_SHARE fz_max.
RICCATI_H16_BAR = 1e-4
#: 15b's routes gated at phase 12a's bars against the optimum.
PARITY_GATED = ("yardstick", "admm_ref", "ipm", "parity")
#: 15c: the oracle controller's ticks on the full-order plant, the
#: configuration whose band it is held to (phase 11a's: Aliengo, h=16,
#: TROTTING16 at 1.0 m/s) and the MuJoCo example's defaults (phase 11b's:
#: h=10, TROTTING10 at 1.2 m/s, from standstill), printed: on this plant
#: the float64 optimum at 11b's nominal start ends outside 11b's band on
#: the CPU (vel_err 0.166 m/s over ticks 1000-1500 against 0.15), where
#: the reference keeps only 86% of jittered starts (FO_REFERENCE_SHARE).
OR_TICKS, OR_PART, OR_PRINTED = 1000, "11a", "11b"


def oracle_on_port_params(mpc, dev):
    """The float64 ``OracleController`` for Aliengo at ``mpc``'s horizon,
    its mass, inertia, fz_max, dt_predict, gravity, mu and weights the
    port's float32 values widened to float64, so the oracle condenses the
    problem the port solves."""
    r = aliengo(device=dev)
    robot = dataclasses.replace(npref.oracle_aliengo(dev), mass=float(r.mass),
                                inertia=r.inertia.double(), fz_max=float(r.fz_max))
    cfg = npref.OracleConfig(horizon=mpc.horizon, dt_predict=float(mpc.dt_predict),
                             gravity=float(mpc.gravity), mu=float(mpc.friction_coef),
                             q_diag=mpc.q_diag.double(), r_scalar=float(mpc.r_diag[0]),
                             device=dev)
    return npref.OracleController(robot, cfg, npref.OracleGait.trotting16(dev))


def oracle_solve(oc, inputs):
    """The oracle's own batched condensing of ``inputs`` (engine_inputs'
    order) and its QP solve: (H, g, table, U*, kkt, iterations), float64."""
    x_t, yaw, feet, X, table = inputs
    H, g = oc._condensed_qp(x_t.double(), yaw.double(), feet.double(),
                            X.reshape(x_t.shape[0], -1).double())
    table = table.double()
    U, kkt, iters = npref.solve_qp_kkt(H, g, oc.cfg.mu, oc.robot.fz_max, table,
                                       device=H.device, return_iterations=True)
    return H, g, table, U, kkt, iters


def rel_to_max(a, b) -> float:
    """Worst per-scenario max|a - b| / max|b|."""
    return float(((a - b).abs().flatten(1).amax(-1) / b.abs().flatten(1).amax(-1)).max())


def phase_oracle_certificate(dev, card, mpc, robot, inputs):
    """15a: the oracle's condensing and QP solve of the main path's first
    solve tick at B=4096, h=16, on the card: certificates, the CPU, the C++
    oracle and the port's condensing."""
    oc = oracle_on_port_params(mpc, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H, g, table, U, kkt, iters = oracle_solve(oc, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cert = kkt.amax(-1)
    it = iters.double()

    cpu = torch.device("cpu")
    oc_c = oracle_on_port_params(tree.to(mpc, cpu), cpu)
    t0 = time.perf_counter()
    *_, U_c, kkt_c, _ = oracle_solve(oc_c, tuple(t[:CPU_B].cpu() for t in inputs))
    cpu_wall = time.perf_counter() - t0
    U_h = U.cpu()
    cpu_err = float(((U_h[:CPU_B] - U_c).abs() / (1.0 + U_c.abs())).max())

    cpp_err, cpp_cost, cpp_cert = 0.0, 0.0, 0.0
    for i in range(ORACLE_CPP_N):
        Hi, gi = H[i].cpu(), g[i].cpu()
        U_cc, kkt_cc = oracle_cpp.solve_qp(Hi, gi, table[i].cpu(), oc.cfg.mu, oc.robot.fz_max,
                                           tol=ORACLE_TOL)
        mv = table[i].cpu().repeat_interleave(3)
        cpp_err = max(cpp_err, float(((U_cc - U_h[i]) * mv).abs().div(
            1.0 + (U_h[i] * mv).abs()).max()))
        q_cc, q = (float(f64_cost(Hi[None], gi[None], V[None] * mv)) for V in (U_cc, U_h[i]))
        cpp_cost = max(cpp_cost, abs(q_cc - q) / (abs(q) + 1.0))
        cpp_cert = max(cpp_cert, float(kkt_cc.max()))

    # The port's float64 condensing: float64 state space and discretization
    # (srb) and condense_ff's hi + lo words; then build_qp_ff as it runs.
    f64 = lambda t: t.double() if t.is_floating_point() else t
    robot64, mpc64 = tree.tree_map(f64, robot), tree.tree_map(f64, mpc)
    x_t, yaw, feet, X, tbl = inputs
    Ad, Bd = srb.discretize(*srb.state_space(robot64, yaw.double(), feet.double()),
                            mpc64.dt_predict)
    hi, lo, ghi, glo = condense.condense_ff(Ad, Bd, x_t.double(), X.double(), mpc64)
    d_H = rel_to_max(hi.double() + lo.double(), H)
    d_g = rel_to_max(ghi.double() + glo.double(), g)
    del Ad, Bd, hi, lo
    hi, lo, ghi, glo, mv = refmpc.build_qp_ff(robot, mpc, *inputs)
    Hm, gm = cones.mask_cost(H, g, mv.double())
    f_H = rel_to_max(hi.double() + lo.double(), Hm)
    f_g = rel_to_max(ghi.double() + glo.double(), gm)
    del hi, lo, Hm, gm
    print(f"phase 15a: float64 oracle (oracle/npref.py) on the card at B={B_MAIN} h={HORIZON}, "
          f"the main path's first solve tick: its own batched condensing and solve_qp_kkt in "
          f"{wall:.2f} s, interior-point iterations p50 {float(it.median()):.0f} / max "
          f"{int(iters.max())}; certificate max(kkt) p50 {float(cert.median()):.3e} / max "
          f"{float(cert.max()):.3e} (bar {ORACLE_KKT_BAR:g} for every scenario) [{card}]",
          flush=True)
    print(f"phase 15a: the first {CPU_B} scenarios by the oracle on the CPU ({cpu_wall:.2f} s): "
          f"max |dU|/(1+|U|) {cpu_err:.3e} (bar {ORACLE_CPU_BAR:g}); {ORACLE_CPP_N} through the "
          f"C++ oracle (csrc/qp_oracle.cc, tol {ORACLE_TOL:g}): f64 cost difference max "
          f"{cpp_cost:.3e} (bar {ORACLE_CPP_COST_BAR:g}), |dU|/(1+|U|) max {cpp_err:.3e} "
          f"(printed, not gated), its certificate max {cpp_cert:.3e}; condensing against the "
          f"port's float64 condense_ff: H {d_H:.3e}, g {d_g:.3e} of max|H|, max|g| (bar "
          f"{CONDENSE_BAR:g}); against "
          f"build_qp_ff (float32 discretization): H {f_H:.3e}, g {f_g:.3e} (bar "
          f"{CONDENSE_F32_BAR:g})", flush=True)
    check(bool(torch.isfinite(U).all()) and float(cert.max()) < ORACLE_KKT_BAR,
          "phase 15a: a scenario's oracle certificate is above its bar")
    check(cpu_err < ORACLE_CPU_BAR, "phase 15a: the oracle on the card disagrees with the CPU")
    check(cpp_cost < ORACLE_CPP_COST_BAR and cpp_cert < ORACLE_KKT_BAR,
          "phase 15a: the C++ oracle disagrees with the torch oracle")
    check(max(d_H, d_g) < CONDENSE_BAR and max(f_H, f_g) < CONDENSE_F32_BAR,
          "phase 15a: the port's condensing disagrees with the oracle's")
    return (H, g, table, U), dict(
        wall_s=wall, cpu_wall_s=cpu_wall, iterations_p50=float(it.median()),
        iterations_max=int(iters.max()), kkt_max=float(cert.max()), cpu_max_rel=cpu_err,
        cpp_max_rel=cpp_err, cpp_cost_rel=cpp_cost, condense_H=d_H, condense_g=d_g,
        build_qp_ff_H=f_H, build_qp_ff_g=f_g)


def kernel_routes(mpc, robot, inputs, plain=False) -> dict:
    """Phase 15b's kernel routes, cold, at the in-loop presets, each a
    function returning the swing-masked full-horizon U (B,12h) in newtons:
    the engine's ``riccati`` (kernel 1) and the condensed backends
    ``pallas_split`` (kernels 2 and 3), ``pallas_fused`` (4), ``pallas_full``
    (5); with ``plain``, each route's plain PyTorch version instead."""
    x_t, yaw, feet, X, table = inputs

    def ric():
        if not plain:
            return engine.solve_scenarios(robot, mpc, *inputs, solver="riccati",
                                          riccati_cfg=riccati.RiccatiConfig.inloop(),
                                          return_full_horizon=True)
        Ad, Bd = srb.discretize(*srb.state_space(robot, yaw, feet), mpc.dt_predict)
        return riccati.solve_batch(Ad, Bd, x_t, X, table, robot.fz_max, mpc,
                                   riccati.RiccatiConfig.inloop(), backend="torch") \
            * cones.variable_mask(table, mpc)

    def condensed(backend):
        def run():
            H, g, mv = refmpc.build_qp(robot, mpc, *inputs)
            return admm_fast.solve_batch(H, g, table, robot.fz_max, mpc,
                                         admm_fast.AdmmFastConfig.inloop(),
                                         backend="jnp" if plain else backend) * mv
        return run

    return {"riccati": ric, **{b: condensed(b) for b in ("pallas_split", "pallas_fused",
                                                         "pallas_full")}}


def against_optimum(U, U_star, H, g, table, fz_max, mpc) -> dict:
    """Per scenario (B,): the f64 cost excess over U* relative to
    |q(U*)| + 1 on the oracle's problem, max|U - U*| [N], the first-step fz
    error over max(|fz*|, 20 N) (tests/test_riccati.py:139-143) and the
    worst cone-row violation [N]."""
    V = U.double()
    q_star = f64_cost(H, g, U_star)
    fz = lambda W: W.reshape(W.shape[0], -1, 4, 3)[:, 0, :, 2]
    return {
        "excess": (f64_cost(H, g, V) - q_star) / (q_star.abs() + 1.0),
        "du": (V - U_star).abs().amax(-1),
        "fz": ((fz(V) - fz(U_star)).abs() / fz(U_star).abs().clamp(min=20.0)).amax(-1),
        "cone": cone_violation(V, table, fz_max, mpc),
    }


def quantiles(x: torch.Tensor):
    x = x.double()
    return float(x.median()), float(torch.quantile(x, 0.99)), float(x.max())


def phase_oracle_routes(dev, card, mpc, robot, inputs, qp):
    """15b: every solve route and the five kernels against the certified
    optimum U* on the same 4096 problems."""
    H, g, table_o, U_star = qp
    table, fz_max = inputs[4], float(robot.fz_max.max())
    mv = table.repeat_interleave(3, dim=-1)
    torch.cuda.synchronize()
    reset_launches()
    U = {name: fn() for name, fn in kernel_routes(mpc, robot, inputs).items()}
    U["yardstick"] = yardstick(mpc, robot, inputs)[0]
    U.update({name: fn() for name, fn in parity_routes(mpc, robot, inputs).items()})
    torch.cuda.synchronize()
    launches = kernel_launches()
    # build_qp condenses on the card for the three condensed kernel routes,
    # the yardstick, admm_ref and ipm; the parity route condenses in float64.
    want = {"riccati_admm": 1, "invert_spd": 2, "iterate": 2, "iterate_fused": 1, "solve_full": 1,
            "condense": 6}
    check(launches == want, f"phase 15b: kernel launches {launches}, expected {want}")
    # The kernel routes' plain versions on the same inputs (no launch), to
    # tell the kernels' share of a gap to the optimum from the algorithm's.
    plain = {name: fn() for name, fn in kernel_routes(mpc, robot, inputs, plain=True).items()}
    cone_bar = CONE_SHARE * fz_max
    report, findings = {}, []
    for name, V in U.items():
        m = against_optimum(V, U_star, H, g, table, robot.fz_max, mpc)
        finite = bool(torch.isfinite(V).all())
        swing_zero = bool((V[mv == 0] == 0).all())
        q = {k: quantiles(v) for k, v in m.items()}
        report[name] = {k: dict(zip(("p50", "p99", "max"), v)) for k, v in q.items()}
        gated = name in PARITY_GATED
        if gated:
            bars = (f" (bars {PARITY_COST_BAR:g} p99, {WORST_FACTOR * PARITY_COST_BAR:g} max)",
                    f" (bar {cone_bar:g} max)")
        else:
            bars = (f" (h=16 bar {RICCATI_H16_BAR:g} p99: a finding above it)",
                    f" (bar {cone_bar:g} p99: a finding above it; {WORST_FACTOR * cone_bar:g} "
                    f"max)")
        line = (f"phase 15b: {name} against the f64 optimum at B={B_MAIN} h={HORIZON} (p50 / p99 "
                f"/ max): cost excess {q['excess'][0]:.3e} / {q['excess'][1]:.3e} / "
                f"{q['excess'][2]:.3e}{bars[0]}; max|U - U*| {q['du'][0]:.3e} / "
                f"{q['du'][1]:.3e} / {q['du'][2]:.3e} N; first-step fz error {q['fz'][0]:.3e} / "
                f"{q['fz'][1]:.3e} / {q['fz'][2]:.3e}; cone violation {q['cone'][0]:.3e} / "
                f"{q['cone'][1]:.3e} / {q['cone'][2]:.3e} N{bars[1]}; finite {finite}, swing "
                f"forces exactly 0 {swing_zero}")
        ok = finite and swing_zero
        if gated:
            ok = ok and q["cone"][2] <= cone_bar and q["excess"][1] <= PARITY_COST_BAR \
                and q["excess"][2] <= WORST_FACTOR * PARITY_COST_BAR
        else:
            mp = against_optimum(plain[name], U_star, H, g, table, robot.fz_max, mpc)
            pl = report[name]["plain"] = {"excess_p99": quantiles(mp["excess"])[1],
                                          "cone_max": quantiles(mp["cone"])[2]}
            line += (f"; its plain version: cost excess p99 {pl['excess_p99']:.3e}, cone "
                     f"violation max {pl['cone_max']:.3e} N")
            ok = ok and q["cone"][2] <= WORST_FACTOR * cone_bar
            if q["excess"][1] > RICCATI_H16_BAR or q["cone"][1] > cone_bar:
                findings.append(name)
        print(line + f" [{card}]", flush=True)
        check(ok, f"phase 15b: route {name} outside the bars against the f64 optimum")
    print(f"phase 15b: kernel launches riccati_admm {launches['riccati_admm']}, invert_spd "
          f"{launches['invert_spd']}, iterate {launches['iterate']}, iterate_fused "
          f"{launches['iterate_fused']}, solve_full {launches['solve_full']}; kernel backends "
          f"above the h=16 cost bar or the cone share at p99 (findings, not failures): "
          f"{', '.join(findings) or 'none'} [{card}]", flush=True)
    return launches, dict(routes=report, findings=findings)


def phase_oracle_single_robot(dev, card):
    """15c: the MuJoCo example's oracle controller at B=1 on the card,
    driving ``fullorder.physics_step`` at B=1 through host numpy each tick:
    OR_PART's band, and no kernel of the port launched; then the example's
    own defaults (phase 11b's configuration), printed, not gated."""
    out = {}
    for part in (OR_PART, OR_PRINTED):
        p = FO_PARTS[part]
        step = make_oracle_controller(p["horizon"], "aliengo", p["vx"], 0.0, p["gait"],
                                      device=dev)
        torch.cuda.synchronize()
        reset_launches()
        r = single_robot_loop(dev, step, OR_TICKS, part)
        launches = kernel_launches()
        solve, other = r["solve_tick_ms"], r["other_tick_ms"]
        gated = part == OR_PART
        print(f"phase 15c: make_oracle_controller Aliengo h={p['horizon']} {p['gait']} "
              f"{p['vx']} m/s float64 B=1 on fullorder.physics_step B=1, torques through host "
              f"numpy, {OR_TICKS} ticks in {r['wall_s']:.1f} s: {band_report(r)}"
              f"{'' if gated else ' (printed, not gated)'}; kernel launches "
              f"{sum(launches.values())}; oracle tick on the card, synchronised, host in and "
              f"out: solve ticks p50 {solve['p50']:.3f} / p99 {solve['p99']:.3f} ms, other ticks "
              f"p50 {other['p50']:.3f} / p99 {other['p99']:.3f} ms (not gated) [{card}]",
              flush=True)
        check(not any(launches.values()),
              f"phase 15c: the oracle launched the port's kernels {launches}")
        if gated:
            check(r["ok"] and not r["diverged"],
                  f"phase 15c: the oracle's robot left phase {part}'s band")
        out[part] = {k: r[k] for k in ("ok", "wall_s", "solve_tick_ms", "other_tick_ms",
                                       "final_x", "vel_err", "upright")}
    return out


def phase_oracle(dev, card):
    """Phase 15: 15a, 15b and 15c."""
    t0 = time.perf_counter()
    mpc, robot, inputs = engine_inputs(dev, B_MAIN)
    qp, cert = phase_oracle_certificate(dev, card, mpc, robot, inputs)
    launches, routes = phase_oracle_routes(dev, card, mpc, robot, inputs, qp)
    del qp
    single = phase_oracle_single_robot(dev, card)
    wall = time.perf_counter() - t0
    print(f"phase 15: the float64 oracle took {wall:.1f} s [{card}]", flush=True)
    return launches, {"certificate": cert, **routes, "single_robot": single, "wall_s": wall}


def worker(argv) -> int:
    """``chip_smoke.py --worker solve|sweep|nccl ...``: one process of phase 13."""
    kind, rest = argv[0], argv[1:]
    if kind == "solve":
        worker_solve(int(rest[0]), int(rest[1]), int(rest[2]), rest[3])
    elif kind == "sweep":
        worker_sweep(rest)
    elif kind == "nccl":
        worker_nccl(int(rest[0]))
    else:
        raise SystemExit(f"unknown worker {kind!r}")
    return 0


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
    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2:])
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

    ptxas = entry_report(libs["condense"].log, "condense_kernel")
    print(f"phase 1: condense_kernel: ptxas: {ptxas}", flush=True)

    max_err = phase_kernel_vs_plain(dev)
    ric_launches, loop_state = phase_closed_loop(dev, "riccati", 3)
    ric_times = phase_times(dev, card, loop_state)
    del loop_state
    cond_err = phase_condensed_vs_plain(dev)
    condensing = phase_condense(dev, card, libs)
    cond_launches, loop_state = phase_closed_loop(dev, "admm_fast", 6)
    cond_times, backend_launches = phase_condensed_times(dev, card, loop_state)
    del loop_state
    rollout_launches, rollout_times = {}, {}
    for solver in ("riccati", "admm_fast"):
        launches, rollout_times[solver] = phase_rollout(dev, card, solver)
        rollout_launches.update({k: v for k, v in launches.items() if v})
    ctrl_tick = phase_ctrl_tick(dev, card)
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
    sharded = phase_sharded(dev, card)
    t0 = time.perf_counter()
    sr_launches, single = phase_single_robot(dev, card)
    bv_launches, grid = phase_batch_viz(dev, card)
    surfaces = {"single_robot": single, "batch_viz": grid, "se3": phase_se3_toeplitz(dev, card),
                "nan": phase_nan_isolation(dev, card), "wall_s": time.perf_counter() - t0}
    print(f"phase 14: the single robot, the grid, SE(3) and NaN isolation took "
          f"{surfaces['wall_s']:.1f} s [{card}]", flush=True)
    oracle_launches, oracle = phase_oracle(dev, card)
    oracle_in = "15b: each route once, B=4096, h=16, cold, in-loop presets"

    kernels = [{
        "name": "riccati_admm", "route": "cuda",
        "source": "pympc_quadruped_tpu_torch/csrc/riccati_admm.cu",
        "replaces": "pympc_quadruped_tpu/ops/qp/riccati_pallas.py:116",
        "launches": rollout_launches["riccati_admm"],
        "launches_in": "rollout(solver='riccati'), 3000 ticks, 150 solves",
        "launches_run_ticks": ric_launches["riccati_admm"],
        "launches_fullorder": fo_launches["riccati_admm"],
        "launches_fullorder_in": FO_LAUNCHES_IN["riccati"],
        "launches_sharded": sharded["solve"]["riccati"]["launches"],
        "launches_sharded_in": "13a: each rank's one solve_sweep_step, B=2048 of 4096",
        "max_abs_err": max(max_err, *(v["max_abs_err"] for k, v in sharded["solve"]["riccati"]
                                      .items() if k.startswith("kernel_vs_plain"))),
        "err": "max|dU| [N] vs plain; worst of h=16 (B=4096, 130) and h=10 (13a, B=4096, 2048)",
        "launches_oracle": oracle_launches["riccati_admm"], "launches_oracle_in": oracle_in,
        **ric_times, "library_ms": None,
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
                "launches_fullorder_in": FO_LAUNCHES_IN["admm_fast"],
                "launches_sharded": [w[name] for w in sharded["launches"]["13b"]],
                "launches_sharded_in": f"13b: each rank's sweep entry point, "
                                       f"{int(SH_SECONDS * 1e3)} ticks, B=2048 of 4096",
                "launches_single_robot": sr_launches[name],
                "launches_single_robot_in": f"14a: make_torch_controller B=1, h=10, "
                                            f"{SR_TICKS} ticks, {SR_TICKS // PERIOD} solves",
                "launches_batch_viz": bv_launches[name],
                "launches_batch_viz_in": f"14b: record_batch B={BV_B}, h=10, {BV_TICKS} "
                                         f"ticks, {BV_TICKS // PERIOD} solves"}
               if on_loop else {}),
            "launches_oracle": oracle_launches[name], "launches_oracle_in": oracle_in,
            "max_abs_err": cond_err[name], "err": errs[name], **cond_times[name],
        })
    mirrors = {"srb_observe": "env/srb_env.py observe", "ctrl_pre": "control/controller.py "
               "_pre_solve", "ctrl_post": "control/controller.py _post_solve"}
    for name in CTRL_KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pympc_quadruped_tpu_torch/csrc/ctrl_tick.cu", "replaces": None,
            "mirrors": f"pympc_quadruped_tpu_torch/{mirrors[name]}",
            "launches": rollout_launches[name],
            "launches_in": "rollout(solver='admm_fast'), 3000 ticks: the loop's build (graph "
                           "warm-ups and capture, tape warm-ups and recording); none replayed",
            **({"launches_fullorder": fo_launches[name],
                "launches_fullorder_in": FO_LAUNCHES_IN["admm_fast"]}
               if name != "srb_observe" else {}),
            "max_abs_err": max(ctrl_tick[h][name]["max_ulps"] for h in ctrl_tick),
            "err": f"worst float32 ulps of a field's largest magnitude against the plain "
                   f"function (bar {CTRL_ULPS:g}), {CTRL_SHADOW_TICKS} closed-loop ticks at "
                   f"B={B_MAIN}, h=16 and h=10",
            **{f"{k}_h{h}" if h != HORIZON else k: v for h in ctrl_tick
               for k, v in ctrl_tick[h][name].items()},
        })
    print(json.dumps({"rollout": rollout_times}))
    print(json.dumps({"fullorder": fo_times}))
    print(json.dumps({"parity": parity}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"surfaces": surfaces}))
    print(json.dumps({"oracle": oracle}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"condense": {
        "name": "condense", "route": "cuda", "source": "pympc_quadruped_tpu_torch/csrc/condense.cu",
        "replaces": None, "launches_run_ticks": cond_launches["condense"],
        "launches": rollout_launches["condense"], "launches_oracle": oracle_launches["condense"],
        "per_horizon": condensing}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
