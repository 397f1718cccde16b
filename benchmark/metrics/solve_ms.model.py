"""Median device time (CUDA events) of the reference trajectory and the
QP's operands in the window's solve ticks (span ``solve.model``)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.device_median(_spans.snapshot(), rec, cell, cfg, ("solve.model",))
