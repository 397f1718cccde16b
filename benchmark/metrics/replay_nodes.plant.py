"""Kernel nodes of the plant layer in the loop's plain graph (span
``tick.plant``, counted at capture)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.nodes(_spans.snapshot(), "tick.plant")
