"""Kernel nodes of the controller layer in the loop's plain graph
(span ``tick.controller``, counted at capture)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.nodes(_spans.snapshot(), "tick.controller")
