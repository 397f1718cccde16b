"""Mean time of the eager solve tick in the window: the total over the
window's periods (CUDA events around each period's first tick) over their
count."""


def read(rec, cell, cfg):
    ms = rec.get("solve_ms")
    return sum(ms) / len(ms) if ms else None
