"""Median over the traced replays of the plant layer's time on the card's
clock (the ``tick.plant`` stamps of the traced graph)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.replay_median(_spans.snapshot(), "tick.plant")
