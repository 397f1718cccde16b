"""Kernel nodes of the divergence, reset and metric-row layer in the
loop's plain graph (span ``tick.rows``, counted at capture)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.nodes(_spans.snapshot(), "tick.rows")
