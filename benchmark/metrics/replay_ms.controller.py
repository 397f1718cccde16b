"""Median over the traced replays of the controller layer's time on the
card's clock (the ``tick.controller`` stamps of the traced graph)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.replay_median(_spans.snapshot(), "tick.controller")
