"""On the card, at a cell's own size: the port's run is correct and the
control (the reference in TF32 in the port's place) is not.  Run with
``python -m pytest benchmark/tests -m cuda``; skips where no card is
present, and the sweep cell where fewer than its four cards are."""
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


@pytest.mark.cuda
def test_sweep_correct_and_control_not():
    """The sweep cell on four cards, one NCCL rank each, at its own size and
    a short window: every rank's closed-loop answers, hand-over, readback
    and reductions within their limits, the TF32 control's answers not;
    the verdict is false exactly where a number is over its limit."""
    from benchmark.harness import sweep

    cell = "sweep-h10-dr-x4"
    spec, cfg, mix = manifest.cell_files(cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        pytest.skip(f"needs {spec['chips']} CUDA cards")
    limits = spec["check"]["limits"]
    rec = sweep.run(spec, cfg, mix, [{"seed": 2**34 + 101, "control": True}], 4.0, False,
                    "cuda", time.time())[0]
    for part in rec["per_rank"]:
        n = part["numbers"]
        assert n["handover"] == 0 and n["checkpoint"] == 0, n
        for k in ("qp_data", "cost_excess", "state", "excluded_share", "reduction"):
            assert n[k] <= limits[k], (k, n)
    over = [k for k, r in rec["report"].items() if not r["value"] <= r["limit"]]
    assert rec["correct"] == (not over and rec["failed"] == 0)
    control = {k: {"value": v, "limit": limits[k]} for k, v in rec["control"].items()
               if k in check.NUMBERS}
    assert any(not r["value"] <= r["limit"] for r in control.values()), control
