"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

1. device and build: a CUDA card, its name and power limit, the kernels
   built from ``pympc_quadruped_tpu_torch/csrc`` with nvcc;
2. kernel vs plain: the Riccati-ADMM kernel against its plain PyTorch
   version on the same random h=16 problems on the card, at B=4096 and at
   a ragged B=130: cold, warm-started, and with per-scenario rho;
3. the closed loop: Aliengo, h=16, TROTTING16, 1.2 m/s, B=4096 jittered
   scenarios, 3000 ticks with ``solver="riccati"``; every solve tick must
   launch the kernel and >= 99% of scenarios must hold the trot band;
4. times with CUDA events: one h=16 solve at B=4096 (kernel and plain) and
   one full 20-tick control period at B=4096.

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
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.loop import run_ticks
from pympc_quadruped_tpu_torch.models import Command, Gaits, MpcParams, aliengo
from pympc_quadruped_tpu_torch.ops import lie, srb
from pympc_quadruped_tpu_torch.ops.qp import riccati, riccati_cuda

B_MAIN, B_RAGGED, HORIZON = 4096, 130, 16
N_TICKS, BAND_TICKS, PERIOD = 3000, 750, 20
# Bars of the TPU kernel against its jnp path (tests/test_riccati_pallas.py:146-151).
FZ_REL_BAR, U_ABS_BAR = 0.02, 1.0
BAND_SHARE = 0.99


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


def random_problem(B, h, seed, dev, mass_spread=0.0):
    """Random h-step Riccati problems in the style of the JAX package's
    kernel tests (tests/test_riccati_pallas.py:25-43), made with numpy."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    mpc = tree.to(MpcParams(horizon=h), dev)
    robot = tree.to(tree.tile(aliengo(), B), dev)
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


def phase_kernel_vs_plain(dev):
    worst = 0.0
    for B in (B_MAIN, B_RAGGED):
        for case in ("cold", "warm", "rho"):
            mpc, robot, Ad, Bd, x_t, X_ref, table, u0 = random_problem(
                B, HORIZON, seed=3, dev=dev, mass_spread=0.3 if case == "rho" else 0.0)
            cfg = riccati.RiccatiConfig.inloop() if case == "rho" else riccati.RiccatiConfig()
            h = mpc.horizon
            m_u, gate = riccati.step_gating(table, h)
            l, u_bnd = riccati.step_bounds(table, robot.fz_max, h)
            rho_b = cfg.rho * riccati.rho_scale_from_Bd(Bd, mpc) if cfg.normalize else None
            hu = riccati.input_cost_diag(m_u, mpc, cfg, rho_b=rho_b)
            init = None
            if case == "warm":
                z0 = torch.zeros_like(gate)
                init = (u0, z0, z0.clone())
            if rho_b is not None:
                check(float(rho_b.max() / rho_b.min()) > 1.5, "rho case: rho_b does not vary")
            U_k, y_k = riccati_cuda.factor_iterate(
                Ad, Bd, x_t, X_ref, hu, m_u, gate, l, u_bnd, mpc, cfg, init, rho_b=rho_b)
            fac = riccati.lqr_factor(Ad, Bd, hu, m_u, mpc)
            U_p, y_p = riccati.iterate(fac, Ad, x_t, X_ref, gate, l, u_bnd, mpc, cfg,
                                       init, rho_b=rho_b)
            torch.cuda.synchronize()
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


def closed_loop_setup(dev):
    B = B_MAIN
    mpc = tree.to(MpcParams(horizon=HORIZON), dev)
    robot = tree.to(tree.tile(aliengo(), B), dev)
    gait = tree.to(tree.tile(Gaits.trotting16(), B), dev)
    cmd = tree.to(tree.tile(Command.trot_forward(1.2), B), dev)
    carry = tree.to(tree.tile(ctrl.init_carry(HORIZON), B), dev)
    return mpc, robot, gait, cmd, carry, jittered_init(robot, B, seed=31, dev=dev)


def phase_closed_loop(dev):
    mpc, robot, gait, cmd, carry, state = closed_loop_setup(dev)
    B = B_MAIN
    diverged = torch.zeros(B, dtype=torch.bool, device=dev)
    vel_err_sum = torch.zeros(B, device=dev)
    torch.cuda.synchronize()
    riccati_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    for tick in range(N_TICKS):
        R = lie.quat_to_rotmat(state.quat)            # the tick's observed base rotation
        carry, state, out = run_ticks(robot, mpc, gait, cmd, carry, state, tick, 1)
        diverged |= srb_env._diverged(state)
        if tick >= N_TICKS - BAND_TICKS:
            vel_des = (R @ cmd.vel_base_des[..., None])[..., 0]
            vel_err_sum += torch.linalg.vector_norm(state.vel - vel_des, dim=-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = riccati_cuda.LAUNCHES
    n_solves = N_TICKS // PERIOD
    check(launches == n_solves, f"kernel launched {launches} times, expected {n_solves}")
    check(tuple(out.contact_forces.shape) == (B, 12) and tuple(out.torques.shape) == (B, 12),
          "closed-loop output shapes")
    check(bool(torch.isfinite(out.torques).all()), "non-finite torques at the last tick")
    vel_err = vel_err_sum / BAND_TICKS
    height, x = state.pos[:, 2], state.pos[:, 0]
    ok = (~diverged) & (vel_err < 0.15) & (height > 0.34) & (height < 0.42) & (x > 2.0)
    share = float(ok.float().mean())
    print(f"phase 3: closed loop B={B} h={HORIZON} {N_TICKS} ticks in {wall:.1f} s: "
          f"{int(ok.sum())}/{B} in band ({share:.4f}, bar {BAND_SHARE}); kernel launches "
          f"{launches}; median vel_err {float(vel_err.median()):.4f} m/s, "
          f"median final height {float(height.median()):.4f} m, median x {float(x.median()):.3f} m",
          flush=True)
    check(share >= BAND_SHARE, f"only {share:.4f} of scenarios in the band")
    return launches, (mpc, robot, gait, cmd, carry, state)


def phase_times(dev, card, loop_state):
    mpc, robot, Ad, Bd, x_t, X_ref, table, u0 = random_problem(B_MAIN, HORIZON, seed=5, dev=dev)
    cfg = riccati.RiccatiConfig.inloop()
    solve = lambda backend: riccati.solve_batch(
        Ad, Bd, x_t, X_ref, table, robot.fz_max, mpc, cfg, backend=backend)
    ms_kernel = cuda_ms(lambda: solve("cuda"))
    ms_plain = cuda_ms(lambda: solve("torch"))
    print(f"phase 4: one h={HORIZON} Riccati-ADMM solve at B={B_MAIN} (inloop, 40 it): "
          f"kernel {ms_kernel:.3f} ms, plain PyTorch {ms_plain:.3f} ms [{card}]", flush=True)

    mpc, robot, gait, cmd, carry, state = loop_state
    tick = [N_TICKS]

    def period():
        nonlocal carry, state
        carry, state, _ = run_ticks(robot, mpc, gait, cmd, carry, state, tick[0], PERIOD)
        tick[0] += PERIOD

    ms_period = cuda_ms(period)
    print(f"phase 4: one {PERIOD}-tick control period (1 solve tick) at B={B_MAIN}: "
          f"{ms_period:.3f} ms against the 20 ms real-time budget [{card}]", flush=True)
    return ms_kernel, ms_plain, ms_period


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
    built = _build.load()
    here = os.path.dirname(os.path.abspath(__file__))
    ptxas = [l.split(":", 1)[1].strip() for l in built.log.splitlines() if "Used" in l]
    print(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}); kernels built in {built.build_seconds:.1f} s "
          f"into {os.path.relpath(built.path, here)}; ptxas: {'; '.join(ptxas)}", flush=True)

    max_err = phase_kernel_vs_plain(dev)
    launches, loop_state = phase_closed_loop(dev)
    ms_kernel, ms_plain, ms_period = phase_times(dev, card, loop_state)

    print(json.dumps({"kernels": [{
        "name": "riccati_admm",
        "route": "cuda",
        "source": "pympc_quadruped_tpu_torch/csrc/riccati_admm.cu",
        "replaces": "pympc_quadruped_tpu/ops/qp/riccati_pallas.py:116",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
