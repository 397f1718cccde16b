"""The sweep cell's checkpoint retention on the CPU: two gloo ranks of the
sweep entry, as tests/test_bench_sweep.py runs them, keep the
configuration's ``checkpoint_keep`` newest steps (or every save, where
fewer were made), so ``kept_steps_off`` reads 0 on every rank and the
run's check passes."""
import pytest

from benchmark import run
from benchmark.harness import manifest

CELL = "sweep-h10-dr-x4"
SEED = 2**33 + 101
#: Two ranks of four robots, four periods a chunk.
SIZES = dict(batch=8, ranks=2, chunk_ticks=80)


@pytest.fixture(scope="module")
def record():
    spec, cfg, mix = manifest.cell_files(CELL)
    args = run.parse_args(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5",
                           "--trace", "0"])
    return cfg, run.sweep_cell(args, spec, cfg, mix, device="cpu", **SIZES)


def test_every_rank_keeps_checkpoint_keep_steps(record):
    cfg, rec = record
    keep = cfg["checkpoint_keep"]
    assert keep == 3
    for part in rec["per_rank"]:
        assert part["saves"] >= keep
        assert part["kept_steps"] == min(keep, part["saves"])
        assert part["numbers"]["kept_steps_off"] == 0


def test_the_run_is_correct(record):
    _, rec = record
    assert rec["report"]["kept_steps_off"] == {"value": 0.0, "limit": 0}
    assert rec["correct"] and rec["failed"] == 0, rec["report"]
