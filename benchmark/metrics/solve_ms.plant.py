"""Median device time (CUDA events) of the plant's step in the window's
solve ticks (span ``tick.plant``)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.device_median(_spans.snapshot(), rec, cell, cfg, ("tick.plant",))
