"""On the card, at a cell's own size: the port's run is correct and the
control (the reference in TF32 in the port's place) is not.  Run with
``python -m pytest benchmark/tests -m cuda``; skips where no card is
present."""
import time

import pytest
import torch

from benchmark.harness import check, closed_loop, manifest, program

CELLS = [w["name"] for w in manifest.manifest()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_port_correct_and_control_not(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import pympc_quadruped_tpu_torch  # noqa: F401

    _, _, spec, cfg, mix = manifest.cell(cell)
    limits = spec["check"]["limits"]
    rec = closed_loop.run(spec, cfg, mix, 2**34 + 99, 2.0, False, "cuda", time.time())
    numbers, _, failed = check.summary(rec["per_answer"], limits)
    assert check.verdict(numbers, limits)[0] and failed == 0, numbers
    per = check.judge(cfg, mix, cfg["solver"], program.robot_rows(cfg, rec["draws"]),
                      rec["draws"], rec["rows"], rec["start"], rec["slots"], "cuda",
                      control=check.TF32)
    numbers, _, failed = check.summary(per, limits)
    assert not check.verdict(numbers, limits)[0] and failed > 0, numbers
