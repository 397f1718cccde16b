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
seeds share one process, so the kernels build and load once; a sweep
cell's share one set of rank processes (``--ranks``, ``--batch`` and
``--chunk-ticks`` shrink it for a rehearsal on the CPU).
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


def _on_result(fault):
    """A fault applied to the result of each call of the function it replaces."""
    return lambda inner: lambda *a, **k: fault(inner(*a, **k))


def _frozen(inner):
    """The plant's step returns the state it was given (the SRB step's third
    argument; the articulated step's fourth, with the contact forces)."""
    def step(*a, **k):
        out = inner(*a, **k)
        if isinstance(out, tuple):
            return (dataclasses.replace(a[3]),) + tuple(out[1:])
        return dataclasses.replace(a[2])
    return step


def _drop_rank(inner):
    """Rank 1's contribution to every reduction left out (zeros in its place)."""
    def reduce(tree, mesh, op):
        from pympc_quadruped_tpu_torch.tree import tree_map

        if mesh.rank == 1:
            tree = tree_map(torch.zeros_like, tree)
        return inner(tree, mesh, op)
    return reduce


def _no_exchange(inner):
    """The exchange between ranks left out: each rank keeps its own values."""
    return lambda tree, mesh, op: tree


def _reset_carry(inner):
    """A chunk's loop starts from the initial carry in place of the one the
    previous chunk handed over."""
    class Loop(inner):
        def __init__(self, *a, **k):
            k["carry_in"] = None
            super().__init__(*a, **k)
    return Loop


def _stale_save(inner):
    """Each save after the first writes the state handed to the one before."""
    held = {}

    def save(self, step, state):
        from pympc_quadruped_tpu_torch.tree import tree_map

        prev = held.get(id(self))
        held[id(self)] = tree_map(torch.clone, state)
        return inner(self, step, state if prev is None else prev)
    return save


#: Faults planted in the port: (where, a function of the replaced function
#: or class that returns its faulty stand-in).  "solver" is the solver's
#: entry that the controller calls; "plant" is the environment's physics
#: step, inside the captured tick; a sweep's faults sit in the reductions
#: ("mesh": ``parallel/mesh._all_reduce``), the chunk's loop ("loop":
#: ``srb_env.RolloutLoop``) and the checkpoint ("checkpoint":
#: ``SweepCheckpointer.save``).
FAULTS = {
    "altered": ("solver", _on_result(_altered)),      # the forces scaled by 1.2
    "half": ("solver", _on_result(_half)),            # half of the batch left unsolved
    "nan_rows": ("solver", _on_result(_solver_nan)),  # every 8th robot's solve not finite
    "nan_state": ("plant", _on_result(_state_nan)),   # every 8th robot's step not finite
    "frozen": ("plant", _frozen),                     # the step returns its state unchanged
    "drop_rank": ("mesh", _drop_rank),                # one rank's summary left out
    "no_exchange": ("mesh", _no_exchange),            # the reductions exchange nothing
    "reset_carry": ("loop", _reset_carry),            # a chunk starts from the initial carry
    "stale_save": ("checkpoint", _stale_save),        # a save writes the previous state
}
#: Where a fault sits only in a sweep's path.
SWEEP_ONLY = ("mesh", "loop", "checkpoint")


def plant(cfg: dict, name: str):
    """Plant the fault ``name`` in the port for a loop built after this
    call; returns the function that takes it out again."""
    from pympc_quadruped_tpu_torch.env import fullorder, srb_env
    from pympc_quadruped_tpu_torch.ops.qp import admm_fast, riccati
    from pympc_quadruped_tpu_torch.parallel import checkpoint, mesh

    where, fault = FAULTS[name]
    module, attr = {
        "solver": ({"admm_fast": admm_fast, "riccati": riccati}[cfg["solver"]], "solve_batch"),
        "plant": ({"srb": srb_env, "fullorder": fullorder}[cfg["plant"]], "physics_step"),
        "mesh": (mesh, "_all_reduce"),
        "loop": (srb_env, "RolloutLoop"),
        "checkpoint": (checkpoint.SweepCheckpointer, "save"),
    }[where]
    inner = getattr(module, attr)
    setattr(module, attr, fault(inner))
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


def calibrate_sweep(args, spec, cfg, mix, seeds, controls, tf32, faults, emit) -> int:
    """The readings of a sweep cell, every run in one set of rank
    processes (the kernels build and load once): the port on ``seeds``,
    with the control (the reference in TF32) on ``controls``, the port with
    TF32 products allowed on ``tf32``, and each fault on ``faults``."""
    from benchmark.harness import sweep

    runs = [{"seed": s, "control": s in controls} for s in sorted(set(seeds) | controls)]
    runs += [{"seed": s, "tf32": True} for s in sorted(tf32)]
    runs += [{"seed": s, "fault": name} for s in sorted(faults) for name in FAULTS]
    sizes = {k: v for k, v in (("batch", args.batch), ("ranks", args.ranks),
                               ("chunk_ticks", args.chunk_ticks)) if v}
    for run, rec in zip(runs, sweep.run(spec, cfg, mix, runs, args.seconds, False, args.device,
                                        time.time(), **sizes)):
        kind = (f"fault_{run['fault']}" if run.get("fault")
                else "program_tf32" if run.get("tf32") else "program")
        row = {"cell": args.workload, "seed": run["seed"], "kind": kind,
               "numbers": rec["numbers"], "correct": rec["correct"],
               "attempted": rec["attempted"], "failed": rec["failed"],
               "periods": len(rec["period_ms"]), "chunks": rec["chunks"],
               "per_rank": [r["numbers"] for r in rec["per_rank"]]}
        emit(row)
        if "control" in rec:
            emit({"cell": args.workload, "seed": run["seed"], "kind": "control_tf32",
                  "numbers": rec["control"]})
    return 0


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
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--chunk-ticks", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import pympc_quadruped_tpu_torch  # noqa: F401  (pins TF32 off)
    from benchmark.harness import check, closed_loop, manifest, program

    spec, cfg, mix = manifest.cell_files(args.workload)
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

    if spec["entry"] == "sweep":
        return calibrate_sweep(args, spec, cfg, mix, seeds, controls, tf32, faults, emit)
    for seed in sorted(faults):
        for name in (n for n, (where, _) in FAULTS.items() if where not in SWEEP_ONLY):
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
