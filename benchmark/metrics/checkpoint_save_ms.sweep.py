"""Host time inside ``SweepCheckpointer.save``: the device-to-host copy of
the rank's state, the wait for its previous write and the two barriers,
not the background write (ms; median over the window's chunks, max over
the ranks)."""
from benchmark.metrics import _sweep


def read(rec, cell, cfg):
    return _sweep.worst_median(rec, "checkpoint_save_ms")
