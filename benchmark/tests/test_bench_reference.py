"""The plain reference against the port's plain path on the CPU, at a few
robots: the whole check of a run passes, and each number is far inside
its limit.  Only this test and the fault tests import both."""
import pytest

from benchmark.tests._runs import run_cell

CELLS = ["srb-h16-trot-admm", "fullorder-h10-mixgait-admm", "srb-h16-trot-riccati"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    ok, n = run_cell(cell)
    assert ok, n
    assert n["diag"]["start"] < 1e-6 and n["qp_data"] < 1e-5 and n["excluded_share"] == 0.0
    assert n["cost_excess"] < 1e-3 and n["state"] < 2e-2


def test_contact_switch_has_two_sides():
    """A foot within rounding of the ground may touch or not; the
    reference's other side flips only such feet, and flipping a falling
    foot switches its damper on."""
    import numpy as np
    import torch

    from benchmark.harness import check, manifest, program
    from benchmark.reference import closed_loop as ref
    from benchmark.reference.precision import F64
    from benchmark.traffic import generator

    _, _, spec, cfg, mix = manifest.cell("fullorder-h10-mixgait-admm")
    draws = generator.draw(mix, 3, 11)
    rows = np.arange(3)
    m, robot, _, _, model, contact = check.inputs(F64, cfg, program.robot_rows(cfg, draws),
                                                  draws, rows, "cpu")
    s = check.initial_state(F64, cfg, mix, robot, draws, rows, "cpu")
    p_bf, _ = ref.leg_fk(robot, s["q"].reshape(3, 4, 3))
    low = p_bf[..., 2].amin(-1) - contact["foot_radius"]
    s["quat"] = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64).expand(3, 4).clone()
    s["pos"][:, 2] = -low + torch.tensor([5e-7, 1e-3, -1e-3], dtype=torch.float64)
    s["u"] = torch.zeros(3, 18, dtype=torch.float64)
    s["u"][:, 5] = -0.1
    tau = torch.zeros(3, 12, dtype=torch.float64)
    one = ref.fullorder_step(F64, robot, model, contact, s, tau, m["dt_control"])
    other = ref.fullorder_step(F64, robot, model, contact, s, tau, m["dt_control"],
                               other_side=True)
    moved = (one["u"] - other["u"]).abs().amax(-1)
    assert moved[0] > 1e-3 and moved[1] == 0 and moved[2] == 0
    assert other["u"][0, 5] > one["u"][0, 5]
