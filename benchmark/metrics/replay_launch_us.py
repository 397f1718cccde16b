"""Median host time of one replay's graph launch over the window (span
``tick.replay``, host clock only).  The registry's ring keeps a span's
newest ``profiling.RING`` (4096) samples, fewer than a 20-s window's
replays on an H100 (about 5-12 thousand), so the median is that of the
window's last 4096 replays, less the traced periods' after it."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.host_median(_spans.snapshot(), rec, cell, cfg, "tick.replay", 1e-3)
