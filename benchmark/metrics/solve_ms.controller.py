"""Median device time (CUDA events) of the controller's work before and
after the solve in the window's solve ticks (spans ``ctrl.pre`` +
``ctrl.post``)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.device_median(_spans.snapshot(), rec, cell, cfg, ("ctrl.pre", "ctrl.post"))
