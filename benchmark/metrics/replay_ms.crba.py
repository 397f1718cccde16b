"""Median over the traced replays of the mass matrix's (CRBA) time on the
card's clock (the ``rbd.crba`` stamps); full-order plant only."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.replay_median(_spans.snapshot(), "rbd.crba")
