"""Median host time of the eager solve tick over the window (span
``tick.solve``), its wait for the card included."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.host_median(_spans.snapshot(), rec, cell, cfg, "tick.solve", 1e-6)
