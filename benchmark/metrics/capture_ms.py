"""Host time to capture and instantiate the newest loop's graphs, plain
and traced (spans ``loop.capture``)."""
from benchmark.metrics import _spans


def read(rec, cell, cfg):
    return _spans.capture_ms(_spans.snapshot())
