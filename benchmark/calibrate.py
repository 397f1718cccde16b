"""The readings that the correctness limits of a cell are set from.

    python3 benchmark/calibrate.py --workload srb-h16-trot-admm --seeds 11,12,13 \
        --control-seeds 11,12,13 --seconds 3

For each seed it runs the cell's timed path as a benchmark run does, at
the cell's size, and prints one JSON line: the check's numbers for the port's answers (the lower
readings) and, for the control seeds, the same numbers for the control, the
reference computed in TF32 put in the port's place (the upper readings;
:mod:`benchmark.reference.precision`).  With ``--tf32-program`` it also
reads the port run with TF32 products allowed, and with ``--fault-seeds``
the port with each fault of :data:`FAULTS` planted.  ``--rows`` and
``--periods`` widen the check's sample; a line whose answers failed lists
them under ``failures``.  The benchmark's own runs never run this.  All
seeds share one process, so the kernels build and load once.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _altered(out):
    U, lam = out
    return U * 1.2, lam


def _half(out):
    U, lam = out
    keep = (torch.arange(U.shape[0], device=U.device) < U.shape[0] // 2)[:, None]
    return U * keep, lam * keep


def _nan_rows(x):
    """``x`` with every 8th row not a number."""
    bad = (torch.arange(x.shape[0], device=x.device) % 8 == 0).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _solver_nan(out):
    U, lam = out
    return _nan_rows(U), lam


def _state_nan(out):
    state = out[0] if isinstance(out, tuple) else out
    state = dataclasses.replace(state, pos=_nan_rows(state.pos))
    return (state,) + tuple(out[1:]) if isinstance(out, tuple) else state


#: Faults planted in the port: (where, what it does to that call's result).
#: "solver" is the solver's entry that the controller calls; "plant" is the
#: environment's physics step, inside the captured tick.
FAULTS = {
    "altered": ("solver", _altered),      # the forces scaled by 1.2
    "half": ("solver", _half),            # half of the batch left unsolved
    "nan_rows": ("solver", _solver_nan),  # every 8th robot's solve not finite
    "nan_state": ("plant", _state_nan),   # every 8th robot's step not finite
}


def plant(cfg: dict, name: str):
    """Plant the fault ``name`` in the port for a loop built after this
    call; returns the function that takes it out again."""
    from pympc_quadruped_tpu_torch.env import fullorder, srb_env
    from pympc_quadruped_tpu_torch.ops.qp import admm_fast, riccati

    where, fault = FAULTS[name]
    if where == "solver":
        module, attr = {"admm_fast": admm_fast, "riccati": riccati}[cfg["solver"]], "solve_batch"
    else:
        module, attr = {"srb": srb_env, "fullorder": fullorder}[cfg["plant"]], "physics_step"
    inner = getattr(module, attr)
    setattr(module, attr, lambda *a, **k: fault(inner(*a, **k)))
    return lambda: setattr(module, attr, inner)


def failures(rec: dict, limits: dict, numbers: dict) -> list:
    """The answers over a limit: (checked tick, robot row, its numbers)."""
    from benchmark.harness import check

    per = rec["per_answer"]
    state = torch.maximum(torch.maximum(per["solve_step"], per["replay_step"]),
                          per["start"][None].expand_as(per["solve_step"]))
    vals = {"qp_data": per["qp_data"], "cost_excess": per["cost_excess"], "state": state}
    over = torch.zeros_like(per["kept"])
    for k, v in vals.items():
        over |= per["kept"] & ~(v <= limits[k])
    out = []
    for i, j in over.nonzero().tolist():
        row = {k: float(v[i, j]) for k, v in vals.items()}
        row.update({k: float(per[k][i, j]) for k in check.DIAGNOSTICS[1:]})
        out.append({"tick": rec["checked_ticks"][i], "row": int(rec["rows"][j]), **row})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--tf32-program", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--periods", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import pympc_quadruped_tpu_torch  # noqa: F401  (pins TF32 off)
    from benchmark.harness import check, closed_loop, manifest, program

    _, _, spec, cfg, mix = manifest.cell(args.workload)
    spec = dict(spec, check=dict(spec["check"]))
    if args.rows:
        spec["check"]["rows"] = args.rows
    if args.periods:
        spec["check"]["periods"] = args.periods
    limits = spec["check"]["limits"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    tf32 = {int(s) for s in args.tf32_program.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def judged(kind, seed, rec, per=None):
        nums, attempted, failed = check.summary(per or rec["per_answer"], limits)
        row = {"cell": args.workload, "seed": seed, "kind": kind, "numbers": nums,
               "attempted": attempted, "failed": failed, "periods": rec["periods"]}
        if failed and per is None:
            row["failures"] = failures(rec, limits, nums)[:20]
        emit(row)

    for seed in sorted(faults):
        for name in FAULTS:
            undo = plant(cfg, name)
            try:
                rec = closed_loop.run(spec, cfg, mix, seed, args.seconds, False, args.device,
                                      time.time(), batch=args.batch)
            finally:
                undo()
            judged(f"fault_{name}", seed, rec)
    for seed in sorted(set(seeds) | controls | tf32):
        runs = ([("program", False)] if seed in seeds else []) + (
            [("program_tf32", True)] if seed in tf32 else [])
        if not runs and seed in controls:
            runs = [("program", False)]
        for kind, allow in runs:
            torch.backends.cuda.matmul.allow_tf32 = allow
            rec = closed_loop.run(spec, cfg, mix, seed, args.seconds, False, args.device,
                                  time.time(), batch=args.batch)
            torch.backends.cuda.matmul.allow_tf32 = False
            judged(kind, seed, rec)
            if seed in controls and kind == "program":
                per = check.judge(cfg, mix, cfg["solver"],
                                  program.robot_rows(cfg, rec["draws"]), rec["draws"],
                                  rec["rows"], rec["start"], rec["slots"], args.device,
                                  control=check.TF32)
                judged("control_tf32", seed, rec, per)
    return 0


if __name__ == "__main__":
    sys.exit(main())
