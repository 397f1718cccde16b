"""Median device time (CUDA events) of the QP solve, with its warm start
and the carry's update, in the window's solve ticks (span ``solve.qp``)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.device_median(_spans.snapshot(), rec, cell, cfg, ("solve.qp",))
