"""Host time from entering a chunk's reductions (``mesh.global_mean``,
``global_max``, ``global_sum``) to holding their result on the host, the
wait for the slowest rank included (ms; median over the window's chunks,
max over the ranks)."""
from benchmark.metrics import _sweep


def read(rec, cell, cfg):
    return _sweep.worst_median(rec, "collective_ms")
