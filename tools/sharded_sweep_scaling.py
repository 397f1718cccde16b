"""The port's sweep entry point on one card and sharded over N cards.

Runs ``python -m pympc_quadruped_tpu_torch.examples.sweep`` (Aliengo, h=10,
trotting10 / pacing10 / bounding8, a checkpoint a chunk) three ways, each
rank a process of its own with torch's launcher variables and
``OMP_NUM_THREADS=1``, as torchrun sets them (``launch.launcher_env``): one rank at
``--batch-per-rank`` scenarios; N ranks, one card each (NCCL), at N times
that batch; and the N-rank run stopped after one chunk and resumed by fresh
processes, whose final checkpoint must equal the straight N-rank run's bit
for bit.  Prints one JSON line a run (the ranks' backends, ticks/s and
per-gait lines) and one for the resume, each with the card's name and
power limit, and appends them to ``chiprun_out/sharded_sweep_scaling.jsonl``.

    python tools/sharded_sweep_scaling.py --ranks 4          # a host with 4 cards
    python tools/sharded_sweep_scaling.py --ranks 4 --device cpu --batch-per-rank 2 \\
        --seconds 0.2 --chunk-ticks 100                      # gloo, on the CPU

Exits non-zero when a run fails or the resume is not bitwise.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pympc_quadruped_tpu_torch import _build  # noqa: E402
from pympc_quadruped_tpu_torch.parallel import checkpoint, launch  # noqa: E402

GAITS = "trotting10,pacing10,bounding8"


def card() -> str:
    if not torch.cuda.is_available():
        return "CPU"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], check=True, capture_output=True, text=True).stdout.strip()


def run(ranks: int, args, ckpt_dir: str, extra=()) -> list[dict]:
    """The entry point as ``ranks`` processes; each rank's printed report."""
    cmd = [sys.executable, "-m", "pympc_quadruped_tpu_torch.examples.sweep",
           "--batch", str(ranks * args.batch_per_rank), "--seconds", str(args.seconds),
           "--chunk-ticks", str(args.chunk_ticks), "--gaits", GAITS, "--device", args.device,
           "--ckpt-dir", ckpt_dir, *extra]
    port = launch.free_port()
    outs = launch.run_ranks([(cmd, launch.launcher_env(port, r, ranks)) for r in range(ranks)],
                            timeout=900)
    return [cs.sweep_report(o) for o in outs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--batch-per-rank", type=int, default=4096)
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--chunk-ticks", type=int, default=500)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"needs {args.ranks} cards, found {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        _build.load_all()          # once here, not in every rank
    where = card()
    out_path = os.path.join(REPO, "chiprun_out", "sharded_sweep_scaling.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)

    def emit(row):
        row = {**row, "card": where, "omp_num_threads": launch.launcher_env()["OMP_NUM_THREADS"],
               "device": args.device, "batch_per_rank": args.batch_per_rank,
               "seconds": args.seconds, "chunk_ticks": args.chunk_ticks}
        print(json.dumps(row), flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "chiprun_out")) as work:
        for ranks in (1, args.ranks):
            t0 = time.perf_counter()
            reps = run(ranks, args, os.path.join(work, f"straight{ranks}"))
            emit({"run": f"{ranks} rank(s)", "ranks": ranks, "wall_s": time.perf_counter() - t0,
                  "backends": [r["backend"] for r in reps],
                  "ticks_per_s": [r["ticks_per_s"] for r in reps],
                  "divergence_max": max(r["divergence_max"] for r in reps),
                  "gaits": reps[0]["gaits"]})
        resumed = os.path.join(work, "resumed")
        run(args.ranks, args, resumed, ["--stop-after-chunks", "1"])
        reps = run(args.ranks, args, resumed)
        step_a, a = checkpoint.read_step(os.path.join(work, f"straight{args.ranks}"))
        step_b, b = checkpoint.read_step(resumed)
        differ = [cs.differing_leaves(x, y) for x, y in zip(a, b)]
        ok = step_a == step_b and not any(differ) and all(r["resumed"] for r in reps)
        emit({"run": f"{args.ranks} ranks stopped after one chunk and resumed",
              "ranks": args.ranks, "resumed": reps[0]["resumed"], "final_step": step_b,
              "leaves": sum(len(x) for x in a), "differing_leaves": differ, "bitwise": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
