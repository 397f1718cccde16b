"""One run of one benchmark cell of the PyTorch + CUDA port.

    python3 benchmark/run.py --workload srb-h16-trot-admm --seed 7 --seconds 20 --trace 0

Run from the root of a checkout.  The cell is looked up in
``BENCHMARK.json``; its files are found by name under ``benchmark/``
(``benchmark/README.md``), and its workload file's ``entry`` says what runs
it (:data:`ENTRIES`): ``closed_loop``, one process on one card, or
``sweep``, one process a rank on one card each.  With ``--trace 0`` the
last line of standard output holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics; both check the timed path's answers
against the plain reference (:mod:`benchmark.harness.check`) and print each
number compared beside its limit as the last lines of standard error.  Exits 3 without a
result where the card, or as many cards as the cell asks for, is missing,
and 4 where JAX or the JAX package was loaded.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so a second run
    finds what the first built.  (The port's own libraries go to
    ``pympc_quadruped_tpu_torch/_build/``, also inside the checkout.)"""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def percentile(xs, q: float) -> float:
    """The ``q``-th percentile of ``xs``, linear between order statistics."""
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def card_power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def end_to_end(rec: dict) -> dict:
    out = {"ticks_per_s": rec["ticks"] / rec["wall_s"], "setup_s": rec["setup_s"]}
    if rec.get("period_ms"):
        out["period_p95_ms"] = percentile(rec["period_ms"], 95.0)
    return out


def layer_or_e2e(args, man: dict, spec: dict, cfg: dict, rec: dict) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones."""
    from benchmark.harness import manifest

    units = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    metrics = {}
    if args.trace:
        for m in manifest.metrics_of(man, args.workload, "per_layer"):
            value = manifest.reader(m["name"])(rec, spec, cfg)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        e2e = end_to_end(rec)
        for m in manifest.metrics_of(man, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": units[m["name"]]}
    return metrics


def breakdown(rec: dict) -> dict:
    ops = sorted(rec["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[k, v[0]] for k, v in ops], "idle_gaps": rec["idle_gaps"]}


def closed_loop_cell(args, spec: dict, cfg: dict, mix: dict) -> dict:
    """Entry ``closed_loop``: one card, one process
    (:mod:`benchmark.harness.closed_loop`)."""
    import torch

    import pympc_quadruped_tpu_torch  # noqa: F401  (pins TF32 off for the port)
    from benchmark.harness import check, closed_loop

    rec = closed_loop.run(spec, cfg, mix, args.seed, args.seconds, bool(args.trace), "cuda",
                          T_START)
    limits = spec["check"]["limits"]
    numbers, attempted, failed = check.summary(rec["per_answer"], limits)
    correct, report = check.verdict(numbers, limits)
    rec.update(correct=correct and failed == 0, attempted=attempted, failed=failed,
               report=report, kind=torch.cuda.get_device_name(0))
    rec["info"] = {
        "card": card_power(), "periods": rec["periods"],
        "loop_ticks_per_s": rec["loop_ticks_per_s"], "setup_parts_s": rec["setup_parts"],
        "wall_s": rec["wall_s"], "launches": rec["launches"], "captures": rec["captures"],
        "solve_calls": rec["solve_calls"], "graph_nodes": rec.get("graph_nodes"),
        "check_s": rec["check_s"], "checked_ticks": rec["checked_ticks"]}
    return rec


def sweep_cell(args, spec: dict, cfg: dict, mix: dict, device="cuda", **sizes) -> dict:
    """Entry ``sweep``: one process a rank, one card each
    (:mod:`benchmark.harness.sweep`); rank 0's record, with each rank's
    check numbers.  ``sizes`` (``batch``, ``ranks``, ``chunk_ticks``) and
    a CPU ``device`` are for the tests."""
    from benchmark.harness import sweep

    rec = sweep.run(spec, cfg, mix, [{"seed": args.seed}], args.seconds, bool(args.trace),
                    device, T_START, **sizes)[0]
    limits = spec["check"]["limits"]
    rec["rank_lines"] = [f"check rank{r} {k} {part['numbers'][k]!r} limit {limits[k]!r}"
                         for r, part in enumerate(rec["per_rank"]) for k in rec["report"]]
    rec["info"] = {
        "card": card_power() if device == "cuda" else "cpu", "chunks": rec["chunks"],
        "periods": len(rec["period_ms"]), "period_quartiles_ms": rec["period_quartiles_ms"],
        "period_median_ms_by_place": rec["period_median_ms_by_place"],
        "wall_s": rec["wall_s"], "build_s": rec["build_s"],
        "setup_parts_s": [p["setup_parts"] for p in rec["per_rank"]],
        "launches": rec["launches"], "captures": rec["captures"],
        "solve_calls": rec["solve_calls"], "kept_steps": [p["kept_steps"] for p in rec["per_rank"]],
        "check_s": [p["check_s"] for p in rec["per_rank"]], "checked_ticks": rec["checked_ticks"]}
    return rec


#: What runs a cell, by the ``entry`` of its ``workloads/<cell>.json``.
ENTRIES = {"closed_loop": closed_loop_cell, "sweep": sweep_cell}


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    fixed_caches()
    import torch

    from benchmark.harness import guard, manifest

    man, entry, spec, cfg, mix = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 3
    rec = ENTRIES[spec["entry"]](args, spec, cfg, mix)
    metrics = layer_or_e2e(args, man, spec, cfg, rec)
    device = {"platform": "gpu", "kind": rec["kind"],
              "count": entry["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": rec["correct"], "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"], device["window_s"] = rec["busy_s"], rec["window_s"]
        result["breakdown"] = breakdown(rec)
    found = sorted(set(guard.forbidden_loaded()) | set(rec.get("forbidden", ())))
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(rec["info"]), file=sys.stderr)
    for line in rec.get("rank_lines", ()):
        print(line, file=sys.stderr)
    for name, r in rec["report"].items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r}", file=sys.stderr)
    result["check"] = rec["report"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
