"""The check comes out false where the timed path is broken: a run on the
CPU with a fault planted in the port, and with the control (the reference
in TF32) in the port's place."""
import dataclasses

import pytest
import torch

from benchmark.harness import check
from benchmark.tests._runs import run_cell


def _patch(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


def test_step_returns_state_unchanged(monkeypatch):
    from pympc_quadruped_tpu_torch.env import srb_env

    _patch(monkeypatch, srb_env, "physics_step", lambda f: lambda robot, mpc, state, *a, **k:
           dataclasses.replace(state))
    ok, n = run_cell("srb-h16-trot-admm")
    assert not ok and n["state"] > 0.3


def test_fullorder_step_returns_state_unchanged(monkeypatch):
    from pympc_quadruped_tpu_torch.env import fullorder

    def frozen(f):
        def step(model, robot, cp, state, tau, dt, terrain=None):
            _, forces = f(model, robot, cp, state, tau, dt, terrain)
            return dataclasses.replace(state), forces
        return step

    _patch(monkeypatch, fullorder, "physics_step", frozen)
    ok, n = run_cell("fullorder-h10-mixgait-admm")
    assert not ok and n["state"] > 0.3


@pytest.mark.parametrize("solver_module, cell", [("admm_fast", "srb-h16-trot-admm"),
                                                 ("riccati", "srb-h16-trot-riccati")])
def test_half_the_batch_left_out(monkeypatch, solver_module, cell):
    from pympc_quadruped_tpu_torch.ops import qp

    module = getattr(__import__(f"{qp.__name__}.{solver_module}").ops.qp, solver_module)

    def half(f):
        def solve(*args, **kwargs):
            U, lam = f(*args, **kwargs)
            keep = torch.arange(U.shape[0]) < U.shape[0] // 2
            return U * keep[:, None], lam * keep[:, None]
        return solve

    _patch(monkeypatch, module, "solve_batch", half)
    ok, n = run_cell(cell)
    assert not ok and n["cost_excess"] > 0.1


def test_answer_altered_where_produced(monkeypatch):
    from pympc_quadruped_tpu_torch.ops.qp import admm_fast

    def altered(f):
        def solve(*args, **kwargs):
            U, lam = f(*args, **kwargs)
            return U * 1.2, lam
        return solve

    _patch(monkeypatch, admm_fast, "solve_batch", altered)
    ok, n = run_cell("srb-h16-trot-admm")
    assert not ok


@pytest.mark.parametrize("cell", ["srb-h16-trot-admm", "srb-h16-trot-riccati"])
def test_control_fails(cell):
    ok, n = run_cell(cell, control=check.TF32)
    assert not ok and n["qp_data"] > 1e-4


@pytest.mark.parametrize("fault, cell", [("nan_rows", "srb-h16-trot-admm"),
                                         ("nan_rows", "srb-h16-trot-riccati"),
                                         ("nan_state", "srb-h16-trot-admm"),
                                         ("nan_state", "fullorder-h10-mixgait-admm")])
def test_not_finite_on_some_rows(fault, cell):
    """A solve or a plant step that is not finite on every 8th robot: the
    controller holds such a row's old forces and drops its plan, and the
    environment resets a robot whose state is not finite, so the fault
    shows as a cost far over the optimum's, or as a robot that falls where
    the reference's does not."""
    from benchmark import calibrate
    from benchmark.harness import manifest

    undo = calibrate.plant(manifest.cell(cell)[3], fault)
    try:
        ok, n = run_cell(cell)
    finally:
        undo()
    assert not ok and n["excluded_share"] == 0.0
    if fault == "nan_state":
        assert n["state"] == float("inf") and n["diag"]["diverged_apart"] == 1.0
    else:
        assert n["cost_excess"] > 0.1
