"""The one generator of every traffic mix: per-robot inputs drawn from a
seed and a mix file of this folder (``<name>.json``).

A mix names its gaits (segment count, stance offsets and durations per
leg, as the reference's gait library defines them) and which of them the
rows draw from, a forward-speed range, and the jitter of the nominal
stance that each robot starts from; a sweep's mix also spreads mass and
inertia, and may give each gait its own speed.  The robots are one fixed pool drawn from the mix (one of them
nominal), and the seed orders them over the rows: every seed runs the same
set of robots, so the work a run does does not change with the seed (each
robot's trajectory is its own; the rows do not interact), while the rows
that the check samples and the order of the batch do.  The same seed gives
the same inputs; the draws are numpy's, so the CPU tests and the card see
the same numbers.
"""
from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of draws for ``seed``; stream 0 is the
    traffic, others serve the harness (which rows and periods to check)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), stream])


#: The seed of the fixed pool of robots that every run's seed reorders.
POOL_SEED = 20260701


def draw(mix: dict, batch: int, seed: int) -> dict:
    """Per-row inputs of ``batch`` robots: ``gait_id`` (B,) into
    ``mix["gait_mix"]``, the gait tables ``num_segments`` (B,),
    ``stance_offsets`` and ``stance_durations`` (B,4), the forward speed
    ``vx`` (B,), the initial-state jitter (``dpos`` (B,3), and ``dvel``
    (B,3) for a rigid-body start or ``dq`` (B,12) and ``du`` (B,18) for
    an articulated one), and the mass and inertia factors (B,): the pool's
    robots in the order ``seed`` draws."""
    pool = _pool(mix, batch)
    order = rng_for(seed, 0).permutation(batch)
    return {k: v[order] for k, v in pool.items()}


def _pool(mix: dict, batch: int) -> dict:
    """``batch`` robots drawn from the mix with :data:`POOL_SEED`; robot 0
    nominal."""
    rng = rng_for(POOL_SEED, 0)
    names = mix["gait_mix"]
    gait_id = rng.integers(0, len(names), batch)
    gait_id[0] = 0
    table = [mix["gaits"][n] for n in names]
    out = {
        "gait_id": gait_id,
        "num_segments": np.array([table[i]["num_segments"] for i in gait_id], np.int64),
        "stance_offsets": np.array([table[i]["stance_offsets"] for i in gait_id], np.int64),
        "stance_durations": np.array([table[i]["stance_durations"] for i in gait_id], np.int64),
    }
    if "speed_by_gait" in mix:
        out["vx"] = np.array([mix["speed_by_gait"][names[i]] for i in gait_id], np.float32)
    else:
        lo, hi = mix["speed"]
        out["vx"] = rng.uniform(lo, hi, batch).astype(np.float32)
        out["vx"][0] = np.float32(hi)
    init = mix["init"]
    dpos = np.zeros((batch, 3), np.float32)
    dpos[1:, :2] = rng.uniform(-init["pos_xy"], init["pos_xy"], (batch - 1, 2))
    dpos[1:, 2] = rng.uniform(-init["pos_z"], init["pos_z"], batch - 1)
    out["dpos"] = dpos
    if init["kind"] == "srb":
        dvel = np.zeros((batch, 3), np.float32)
        dvel[1:] = rng.uniform(-init["vel"], init["vel"], (batch - 1, 3))
        out["dvel"] = dvel
    else:
        dq = np.zeros((batch, 12), np.float32)
        dq[1:] = rng.uniform(-init["q"], init["q"], (batch - 1, 12))
        du = np.zeros((batch, 18), np.float32)
        du[1:] = rng.uniform(-init["u"], init["u"], (batch - 1, 18))
        out["dq"], out["du"] = dq, du
    # Mass and inertia factors log-uniform in [exp(-s), exp(s)], as the
    # production sweep randomizes them (parallel/sweep.randomized_robots).
    s = mix.get("mass_inertia_log_spread", 0.0)
    out["mass_f"] = np.exp(rng.uniform(-s, s, batch)).astype(np.float32)
    out["inertia_f"] = np.exp(rng.uniform(-s, s, batch)).astype(np.float32)
    out["mass_f"][0] = out["inertia_f"][0] = np.float32(1.0)
    return out
