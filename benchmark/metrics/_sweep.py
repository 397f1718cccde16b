"""Shared by the sweep's per-layer readers: a host time that each rank
records once a chunk of the window, from the harness's own code around
its calls into ``parallel/`` and ``srb_env``."""
from __future__ import annotations

import statistics


def worst_median(rec: dict, key: str):
    """The median over the window's chunks, the largest over the ranks; None
    where the record has no ranks (a closed-loop cell)."""
    ranks = [r[key] for r in rec.get("per_rank", ()) if r.get(key)]
    return max(statistics.median(v) for v in ranks) if ranks else None
