"""Synchronising calls per eager solve tick, counted under torch's sync
debug mode in the traced periods (``solve.syncs`` / ``solve.traced_ticks``)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.syncs_per_tick(_spans.snapshot())
