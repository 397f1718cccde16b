"""Host time from a chunk's start to its first period's start: the
``srb_env.RolloutLoop`` build from the state the previous chunk handed over,
with its graph capture (ms; median over the window's chunks, max over the
ranks)."""
from benchmark.metrics import _sweep


def read(rec, cell, cfg):
    return _sweep.worst_median(rec, "chunk_build_ms")
