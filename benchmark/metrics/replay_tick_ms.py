"""Mean time of one replayed non-solve tick in the window: the window's
total replay time (CUDA events around each period's 19 replays) over its
replay count."""


def read(rec, cell, cfg):
    ms = rec.get("replay_ms")
    return sum(ms) / len(ms) if ms else None
