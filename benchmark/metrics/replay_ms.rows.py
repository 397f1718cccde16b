"""Median over the traced replays of the divergence, reset and metric-row
layer's time on the card's clock (the ``tick.rows`` stamps)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.replay_median(_spans.snapshot(), "tick.rows")
