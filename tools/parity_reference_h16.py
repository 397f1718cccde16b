#!/usr/bin/env python
"""How close the parity pipeline comes to the float64 oracle at h=16, in the
JAX package and in the port, on chip_smoke.py phase 12a's scenarios.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_backend_optimization_level=0 \
        python tools/parity_reference_h16.py [--scenarios 4096] [--no-jax] \
        [--nudge 5.960464477539063e-08] [--tree DIR] [--label TEXT]

Phase 12a's scenarios (``chip_smoke.engine_inputs``: phase 3's jittered
h=16 trot at its first solve tick, the first ``--scenarios`` of them, in
chunks of 256) go through the parity pipeline of both frameworks on the
CPU: the JAX package's ``build_qp_ff`` (float-float) + ``ipm.solve_batch(...,
PARITY_CONFIG, H_lo, g_lo)``, and the port's (float64).  Each solution is
compared with the active-set float64 oracle (``oracle/npref.solve_qp_kkt``)
on its own framework's float64 data, as max |U - U*| / (1 + |U*|) per
scenario, over the first-step GRFs (the 12 forces the controller applies)
and over the full horizon; and JAX's solution against the port's (the
same algorithm under two roundings).  Prints one JSON line with the worst
and the 99th percentile of each, and the KKT residual of the oracle.

``--nudge`` also solves the port's problem with its float32 high words H
scaled by (1 + nudge * N(0,1)) elementwise and the low words rewritten so
that H + H_lo stays the same float64 data: a change of rounding only, as
another device or batch size makes.  ``port_nudged_vs_port`` is how far
that moves the answer.  ``--no-jax`` skips the JAX package's solve;
``--tree`` imports the port (and chip_smoke.py) from another checkout,
such as an unpacked earlier commit.  XLA's backend optimization must be
off (as tests/conftest.py sets it) for the float-float arithmetic to stay
exact.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

CHUNK = 256


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=4096)
    ap.add_argument("--no-jax", action="store_true")
    ap.add_argument("--nudge", type=float, default=0.0)
    ap.add_argument("--label", default="")
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   ".."))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from chip_smoke import engine_inputs

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pympc_quadruped_tpu.control import refmpc as jrefmpc
    from pympc_quadruped_tpu.models.mpc import MpcParams
    from pympc_quadruped_tpu.models.robots import aliengo
    from pympc_quadruped_tpu.ops.qp import cones as jcones
    from pympc_quadruped_tpu.ops.qp import ipm as jipm
    from pympc_quadruped_tpu.oracle import npref

    from pympc_quadruped_tpu_torch import tree
    from pympc_quadruped_tpu_torch.control import refmpc
    from pympc_quadruped_tpu_torch.models import aliengo as aliengo_port
    from pympc_quadruped_tpu_torch.ops.qp import cones, ipm

    t0 = time.perf_counter()
    B = args.scenarios
    mpc, _, inputs_all = engine_inputs(torch.device("cpu"), B)
    robot_j, mpc_j = aliengo(), MpcParams(horizon=mpc.horizon)
    f64 = lambda a: np.asarray(a, np.float64)
    rel = lambda U, V: np.abs(U - V) / (1.0 + np.abs(V))
    per = {k: [] for k in ("port_first_step", "port_full")}
    if not args.no_jax:
        per.update({k: [] for k in ("jax_first_step", "jax_full", "jax_vs_port_first_step",
                                    "jax_vs_port_full")})
    if args.nudge:
        per.update({k: [] for k in ("port_nudged_vs_port_first_step", "port_nudged_vs_port_full")})
    gen = torch.Generator().manual_seed(0)
    kkt_worst = 0.0
    for lo in range(0, B, CHUNK):
        inputs = tuple(t[lo:lo + CHUNK] for t in inputs_all)
        robot = tree.tile(aliengo_port(device="cpu"), inputs[0].shape[0])
        table = inputs[4].numpy()
        H, H_lo, g, g_lo, mv = refmpc.build_qp_ff(robot, mpc, *inputs)
        G, h_vec, _ = cones.block_constraints(inputs[4], robot.fz_max, mpc)
        U_port = (ipm.solve_batch(H, g, G, h_vec, ipm.PARITY_CONFIG, H_lo, g_lo) * mv).double()
        H64 = H.double() + H_lo.double()
        solved = {"port": (U_port.numpy(), H64.numpy(), (g.double() + g_lo.double()).numpy())}
        if not args.no_jax:
            Hj, Hj_lo, gj, gj_lo, mvj = jax.vmap(
                lambda x, y, p, Xr, t: jrefmpc.build_qp_ff(robot_j, mpc_j, x, y, p, Xr, t))(
                *(jnp.asarray(t.numpy()) for t in inputs))
            Gj, hj, _ = jax.vmap(lambda t: jcones.block_constraints(t, robot_j.fz_max, mpc_j))(
                jnp.asarray(table))
            U_jax = f64(jipm.solve_batch(Hj, gj, Gj, hj, jipm.PARITY_CONFIG, Hj_lo, gj_lo)) \
                * f64(mvj)
            solved["jax"] = (U_jax, f64(Hj) + f64(Hj_lo), f64(gj) + f64(gj_lo))
            # The same algorithm under two roundings: JAX's solution against the port's.
            r = rel(U_jax, solved["port"][0])
            per["jax_vs_port_first_step"] += list(r[:, :12].max(-1))
            per["jax_vs_port_full"] += list(r.max(-1))
        if args.nudge:
            N = torch.randn(H.shape, generator=gen)
            Hn = H * (1.0 + args.nudge * 0.5 * (N + N.transpose(-1, -2)))
            Hn_lo = (H64 - Hn.double()).float()
            U_n = (ipm.solve_batch(Hn, g, G, h_vec, ipm.PARITY_CONFIG, Hn_lo, g_lo) * mv).double()
            r = rel(U_n.numpy(), U_port.numpy())
            per["port_nudged_vs_port_first_step"] += list(r[:, :12].max(-1))
            per["port_nudged_vs_port_full"] += list(r.max(-1))
        for name, (U, H64_, g64) in solved.items():
            for b in range(len(table)):
                U_star, kkt = npref.solve_qp_kkt(H64_[b], g64[b], float(mpc.friction_coef),
                                                 500.0, table[b])
                kkt_worst = max(kkt_worst, max(kkt))
                r = rel(U[b], U_star)
                per[f"{name}_first_step"].append(r[:12].max())
                per[f"{name}_full"].append(r.max())

    record = {"label": args.label, "scenarios": B, "horizon": mpc.horizon, "nudge": args.nudge,
              "config": {"iterations": ipm.PARITY_CONFIG.iterations,
                         "refine_iters": ipm.PARITY_CONFIG.refine_iters}}
    for key, v in per.items():
        v = np.array(v)
        record[f"{key}_max"] = float(v.max())
        record[f"{key}_p99"] = float(np.percentile(v, 99))
        if not key.startswith(("jax_vs", "port_nudged")):
            record[f"{key}_above_1e-3"] = int((v > 1e-3).sum())
    record["oracle_kkt_max"] = kkt_worst
    record["wall_s"] = round(time.perf_counter() - t0, 1)
    record["jax"] = jax.__version__
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
