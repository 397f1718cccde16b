"""A cell's run on the CPU at a few robots, for the tests: the whole of
``closed_loop.run`` and the check but the look for a card."""
import time

import torch

from benchmark.harness import check, closed_loop, manifest

SEED = 2**35 + 17


def run_cell(cell: str, batch: int = 6, seconds: float = 1.0, seed: int = SEED, control=None):
    """(correct, numbers) of one CPU run of ``cell``; with ``control`` the
    control's numbers in the port's place."""
    import pympc_quadruped_tpu_torch  # noqa: F401

    torch.set_num_threads(2)
    _, _, spec, cfg, mix = manifest.cell(cell)
    rec = closed_loop.run(spec, cfg, mix, seed, seconds, False, "cpu", time.time(), batch=batch)
    per = rec["per_answer"]
    if control is not None:
        from benchmark.harness import program

        per = check.judge(cfg, mix, cfg["solver"], program.robot_rows(cfg, rec["draws"]),
                          rec["draws"], rec["rows"], rec["start"], rec["slots"], "cpu",
                          control=control)
    limits = spec["check"]["limits"]
    numbers, attempted, failed = check.summary(per, limits)
    ok, _ = check.verdict(numbers, limits)
    assert attempted > 0
    return ok and failed == 0, numbers
