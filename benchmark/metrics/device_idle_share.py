"""Share of the traced periods in which no operation ran on the card:
1 - (union of the profiler's device intervals) / (the traced window
between CUDA events), in percent."""


def read(rec, cell, cfg):
    if not rec.get("window_s") or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
