"""Shared by the ``roofline.*`` readers: a kernel's share of its roofline
from the traced periods' device time by kernel name."""
from benchmark import counts


def share(rec, names, work):
    """100 x (least time of one launch at the cell's batch) / (measured time
    per launch of the kernels whose names contain one of ``names``); None
    where the trace holds no launch."""
    total, launches = 0.0, 0
    for name, (seconds, n) in rec.get("kernels", {}).items():
        if any(k in name for k in names):
            total += seconds
            launches += n
    if not launches:
        return None
    least = counts.least_seconds(*work) * rec["batch"]
    return 100.0 * least / (total / launches)
