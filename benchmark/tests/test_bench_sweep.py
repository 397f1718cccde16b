"""The sweep entry on the CPU: two gloo ranks of ``python -m
benchmark.harness.sweep``, started by ``parallel/launch.run_ranks`` as
tests/test_torch_parallel.py starts them, at a few robots a rank and
four-period chunks.  A sound run goes through ``run.py``'s dispatch; the
planted faults of ``calibrate.FAULTS`` share one set of rank processes.
Each number of the check is held to the cell's own limit."""
import math

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import manifest, sweep

CELL = "sweep-h10-dr-x4"
SEED = 2**35 + 23
#: Two ranks of four robots, four periods a chunk.
SIZES = dict(batch=8, ranks=2, chunk_ticks=80)
SECONDS = 0.5
#: Each fault that the cell can have, and the number that must catch it.
FAULT_NUMBER = {
    "frozen": "state",            # a step that returns its state unchanged
    "half": "cost_excess",        # half of the batch left unsolved
    "altered": "cost_excess",     # the forces altered where they are produced
    "no_exchange": "reduction",   # the exchange between ranks left out
    "drop_rank": "reduction",     # one rank's contribution to the summary dropped
    "reset_carry": "handover",    # a chunk started from the initial carry
    "stale_save": "checkpoint",   # a save that writes the previous state
}


@pytest.fixture(scope="module")
def cell_files():
    return manifest.cell_files(CELL)


@pytest.fixture(scope="module")
def sound(cell_files):
    spec, cfg, mix = cell_files
    args = run.parse_args(["--workload", CELL, "--seed", str(SEED), "--seconds", str(SECONDS),
                           "--trace", "1"])
    return run.ENTRIES[spec["entry"]](args, spec, cfg, mix, device="cpu", **SIZES)


@pytest.fixture(scope="module")
def faulty(cell_files):
    spec, cfg, mix = cell_files
    runs = [{"seed": SEED + 1 + i, "fault": f} for i, f in enumerate(FAULT_NUMBER)]
    recs = sweep.run(spec, cfg, mix, runs, SECONDS, False, "cpu", 0.0, **SIZES)
    return dict(zip(FAULT_NUMBER, recs))


def test_entry_is_sweep_on_four_cards(cell_files):
    spec, cfg, _ = cell_files
    assert spec["entry"] == "sweep" and spec["chips"] == cfg["ranks"] == 4
    assert cfg["batch"] == 4 * 4096
    assert cfg["chunk_ticks"] % cfg["mpc"]["iterations_between_mpc"] == 0


def test_sound_run_result(sound, cell_files):
    """The record that ``run.py`` prints from: the window's ticks over both
    ranks, every period of both ranks pooled, the traced window, each
    rank's chunk timings and numbers, and the verdict over the worst."""
    spec, cfg, _ = cell_files
    chunk = SIZES["chunk_ticks"]
    assert sound["chunks"] >= 1 and sound["ticks"] == sound["chunks"] * chunk * SIZES["batch"]
    assert len(sound["period_ms"]) == SIZES["ranks"] * sound["chunks"] * chunk // 20
    assert all(p > 0 for p in sound["period_ms"]) and sound["setup_s"] > 0
    assert sound["window_s"] > 0 and sound["traced_periods"] == spec["trace_periods"]
    assert len(sound["per_rank"]) == SIZES["ranks"]
    for part in sound["per_rank"]:
        for key in ("chunk_build_ms", "collective_ms", "checkpoint_save_ms"):
            assert len(part[key]) == sound["chunks"] and min(part[key]) > 0
    limits = spec["check"]["limits"]
    assert list(sound["report"]) == [k for k in limits]
    over = [k for k, r in sound["report"].items() if not r["value"] <= r["limit"]]
    assert sound["correct"] == (not over and sound["failed"] == 0)
    assert len(sound["rank_lines"]) == SIZES["ranks"] * len(limits)
    assert sound["forbidden"] == []
    e2e = run.end_to_end(sound)
    assert e2e["ticks_per_s"] > 0 and e2e["period_p95_ms"] > 0


def test_sound_run_is_sound(sound, cell_files):
    """The closed loop's answers, the hand-over, the readback and the
    reductions of a sound run are within the cell's limits on every rank
    (the committed steps are ``test_sound_run_keeps_the_newest_step``'s)."""
    limits = cell_files[0]["check"]["limits"]
    for part in sound["per_rank"]:
        n = part["numbers"]
        assert n["handover"] == 0 and n["checkpoint"] == 0
        assert n["reduction"] <= limits["reduction"]
        for k in ("qp_data", "cost_excess", "state", "excluded_share"):
            assert n[k] <= limits[k], (k, n[k])
        assert n["diag"]["start"] < 1e-6


def test_sound_run_keeps_the_newest_step(sound, cell_files):
    """Every save is committed and the newest is read back; the count of
    committed steps is held against ``checkpoint_keep``."""
    keep = cell_files[1]["checkpoint_keep"]
    for part in sound["per_rank"]:
        assert part["saves"] == sound["chunks"] + 2  # warm-up, window, traced
        assert 1 <= part["kept_steps"] <= keep
        assert part["numbers"]["kept_steps_off"] == keep - part["kept_steps"]


@pytest.mark.parametrize("fault", list(FAULT_NUMBER))
def test_planted_fault_fails_the_check(faulty, cell_files, fault):
    limits = cell_files[0]["check"]["limits"]
    rec = faulty[fault]
    number = FAULT_NUMBER[fault]
    assert not rec["correct"] and rec["failed"] > 0
    assert not rec["numbers"][number] <= limits[number], rec["numbers"]


def test_reduction_gap():
    """A float64 recomputation from every rank's per-robot stats: 0 for the
    values it gives, the share left out for a rank dropped from a mean."""
    rng = np.random.default_rng(5)
    T, n = 80, 4
    stats = []
    for _ in range(2):
        tail = rng.uniform(0, 1, (T // 4, n))
        stats.append(np.stack([tail.sum(0), tail.max(0), rng.uniform(0.3, 0.4, n),
                               np.zeros(n), np.ones(n)]))
    s = np.concatenate(stats, axis=1)
    exact = [s[0].sum() / (T // 4 * 2 * n), s[1].max(), s[2].mean(), 1.0, 0.0]
    assert sweep.reduction_gap(np.array(exact), stats, T) == 0.0
    f32 = np.array(exact, np.float32).astype(np.float64)
    assert sweep.reduction_gap(f32, stats, T) < 1e-7
    dropped = np.array(exact)
    dropped[0] = stats[0][0].sum() / (T // 4 * 2 * n)
    assert sweep.reduction_gap(dropped, stats, T) > 0.3
    assert sweep.reduction_gap(np.array(exact[:4] + [1.0]), stats, T) > 1e20
    assert math.isinf(sweep.reduction_gap(np.array(exact[:4] + [math.nan]), stats, T))


def test_bytes_apart():
    a = {"x": torch.tensor([1.0, float("nan"), 3.0]), "b": torch.tensor([True, False])}
    assert float(sweep._bytes_apart(a, {k: v.clone() for k, v in a.items()})) == 0
    b = dict(a, x=torch.tensor([1.0, float("nan"), 3.5]))
    assert 0 < float(sweep._bytes_apart(a, b)) <= 4
    assert math.isinf(sweep._bytes_apart(a, dict(a, x=torch.zeros(4))))
    assert math.isinf(sweep._bytes_apart(a, dict(a, x=a["x"].double())))
    assert math.isinf(sweep._bytes_apart(a, {"x": a["x"]}))
