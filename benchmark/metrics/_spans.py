"""Shared by the readers of the port's own spans and counters
(``pympc_quadruped_tpu_torch.utils.profiling``): the registry's snapshot,
the run's newest loop, and the window's samples.

The window's ticks are ``[warmup_periods x P, (warmup_periods + periods) x
P)``, P the configuration's ``iterations_between_mpc``; a sample's tick is
its control period's solve tick.  The traced periods come after the window.
Every reader returns None where the program keeps no registry (a program
without ``profiling.snapshot``), where the newest loop ran on no card, and
where it finds nothing to read."""
from __future__ import annotations

import numpy as np


def snapshot():
    """The port's registry as host arrays, or None where it has none."""
    try:
        from pympc_quadruped_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def newest_loop(snap):
    """(id, entry) of the newest loop, or None where it ran on no card."""
    if not snap or not snap.get("loops"):
        return None
    i = max(snap["loops"])
    entry = snap["loops"][i]
    return (i, entry) if entry["device"].startswith("cuda") else None


def window(rec, cell, cfg):
    period = cfg["mpc"]["iterations_between_mpc"]
    lo = cell["warmup_periods"] * period
    return lo, lo + rec["periods"] * period


def _samples(snap, loop, name, rec, cell, cfg):
    cols = snap["spans"].get(name)
    if cols is None:
        return None, None
    lo, hi = window(rec, cell, cfg)
    keep = (cols["loop"] == loop) & (cols["tick"] >= lo) & (cols["tick"] < hi)
    return cols, keep


def host_median(snap, rec, cell, cfg, name: str, scale: float):
    """Median host time of span ``name`` over the window's samples that its
    ring still holds (the newest ``profiling.RING``), ns x ``scale``."""
    newest = newest_loop(snap)
    if newest is None:
        return None
    cols, keep = _samples(snap, newest[0], name, rec, cell, cfg)
    if cols is None or not keep.any():
        return None
    return float(np.median(cols["host_ns"][keep])) * scale


def device_median(snap, rec, cell, cfg, names):
    """Median over the window's control periods of the summed device time
    (ms, CUDA events) of the spans ``names`` in each period's solve tick."""
    newest = newest_loop(snap)
    if newest is None:
        return None
    per_period = {}
    for name in names:
        cols, keep = _samples(snap, newest[0], name, rec, cell, cfg)
        if cols is None:
            return None
        for tick, ms in zip(cols["tick"][keep], cols["device_ms"][keep]):
            per_period[int(tick)] = per_period.get(int(tick), 0.0) + float(ms)
    values = np.array(list(per_period.values()))
    if not len(values) or not np.isfinite(values).all():
        return None
    return float(np.median(values))


def replay_median(snap, name: str):
    """Median over the traced replays (stamp rows every column of which a
    replay wrote) of the summed time (ms, ``%globaltimer``) between the
    entry and exit stamps of span ``name`` in the loop's traced graph."""
    newest = newest_loop(snap)
    if newest is None or newest[1]["stamps"] is None:
        return None
    entry = newest[1]
    pairs = [(a, b) for n, _, a, b in entry["layout"] if n == name]
    stamps = entry["stamps"]
    rows = stamps[(stamps != 0).all(axis=1)]
    if not pairs or not len(rows):
        return None
    ns = sum(rows[:, b] - rows[:, a] for a, b in pairs)
    return float(np.median(ns)) * 1e-6


def nodes(snap, name: str):
    """Kernel nodes that span ``name`` adds to the newest loop's plain graph."""
    newest = newest_loop(snap)
    if newest is None or name not in newest[1]["nodes"]:
        return None
    return float(newest[1]["nodes"][name])


def capture_ms(snap):
    """Host time (ms) of the newest loop's ``loop.capture`` spans."""
    newest = newest_loop(snap)
    cols = snap["spans"].get("loop.capture") if newest is not None else None
    if cols is None:
        return None
    keep = cols["loop"] == newest[0]
    return float(cols["host_ns"][keep].sum()) * 1e-6 if keep.any() else None


def syncs_per_tick(snap):
    """Synchronising calls per solve tick traced under torch's sync debug
    mode (``solve.syncs`` / ``solve.traced_ticks``)."""
    if newest_loop(snap) is None:
        return None
    ticks = snap["counters"].get("solve.traced_ticks", 0)
    return snap["counters"].get("solve.syncs", 0) / ticks if ticks else None
