#!/usr/bin/env python
"""The JAX package's in-band share on the full-order trots of chip_smoke.py phase 11.

    JAX_PLATFORMS=cpu python tools/fullorder_reference_share.py --part 11a|11b|14b

Runs the reference ``env/fullorder.rollout`` on the CPU over the 4096
jittered scenarios that ``chip_smoke.py`` phase 11 runs through the port on
the card (the same numpy recipe and seed), and prints one JSON line with
the share of scenarios inside the part's band:

- ``11a``: Aliengo, h=16, TROTTING16, 1.0 m/s, ``solver="riccati"``, 1500
  ticks; band of tests/test_h16_config.py:99-126;
- ``11b``: Aliengo, h=10, TROTTING10, 1.2 m/s, the default ``admm_fast``,
  1500 ticks (bench.py:757's configuration); band of
  tests/test_rbd.py:400-425;
- ``14b``: the mixed-gait grid of ``examples/batch_viz.record_batch`` at
  4096 scenarios (trotting10 / pacing10 / bounding8 by ``i % 3``, the speed
  ramp down the rows, the nominal stance, h=10, ``admm_fast``), run as that
  function runs it: one jitted 40-tick chunk called 38 times, 1520 ticks.
  The line holds the share of each gait's scenarios inside
  ``batch_viz_in_band``.

The parts, the jitter (tests/test_rbd.py:35-65's) and the bands are
chip_smoke.py's own (``FO_PARTS``, ``fullorder_jitter``,
``fullorder_in_band``; ``BV_*``, ``batch_viz_in_band``), so both
frameworks run and judge the same scenarios.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from chip_smoke import (B_MAIN, BV_B, BV_FRAME_TICKS, BV_GAITS, BV_SECONDS, BV_TICKS, BV_VX,
                        FO_PARTS, FO_TICKS, batch_viz_in_band, fullorder_in_band,
                        fullorder_jitter, per_gait_share)


def batch_viz_share(jax, jnp) -> dict:
    """Part 14b: examples/batch_viz.py's record_batch (its lines 31-86) at
    BV_B scenarios, keeping each chunk's metrics."""
    from pympc_quadruped_tpu.control import controller as ctrl
    from pympc_quadruped_tpu.env import fullorder
    from pympc_quadruped_tpu.models.command import Command
    from pympc_quadruped_tpu.models.gaits import Gaits
    from pympc_quadruped_tpu.models.mpc import MpcParams
    from pympc_quadruped_tpu.models.robots import aliengo

    n, vx, frame_ticks = BV_B, BV_VX, BV_FRAME_TICKS
    mpc = MpcParams(horizon=10)
    tile = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), t)
    robot = tile(aliengo())
    gaits = [Gaits.by_name(g) for g in BV_GAITS]
    gait = jax.tree.map(lambda *leaves: jnp.stack([leaves[i % 3] for i in range(n)]),
                        *[jax.tree.map(jnp.asarray, g) for g in gaits])
    vxs = jnp.asarray([vx * (0.6 + 0.4 * (i // 3) / max(1, (n - 1) // 3)) for i in range(n)],
                      jnp.float32)
    cmd = Command(vel_base_des=jnp.stack([jnp.array([float(v), 0.0, 0.0], jnp.float32)
                                          for v in vxs]),
                  yaw_turn_rate=jnp.zeros((n,), jnp.float32))
    state = jax.vmap(fullorder.default_init_state)(robot)
    carry = jax.vmap(lambda _: ctrl.init_carry(mpc.horizon))(jnp.arange(n))

    @jax.jit
    def chunk(state, carry, t0):
        return fullorder.rollout(robot, mpc, gait, cmd, num_ticks=frame_ticks,
                                 state0=state, carry0=carry, tick0=t0)

    rows = []
    for t0 in range(0, int(BV_SECONDS * 1000), frame_ticks):
        (state, carry), m = chunk(state, carry, jnp.int32(t0))
        rows.append({k: np.asarray(v) for k, v in m.items()})
    m = {k: torch.from_numpy(np.concatenate([r[k] for r in rows])) for k in rows[0]}
    assert m["height"].shape == (BV_TICKS, n), m["height"].shape
    ok = batch_viz_in_band(m)
    return {"scenarios": n, "ticks": BV_TICKS, "in_band": int(ok.sum()),
            "share": float(ok.float().mean()), "per_gait": per_gait_share(ok),
            "diverged_any": int(m["diverged"].any(dim=0).sum())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=sorted(FO_PARTS) + ["14b"], required=True)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pympc_quadruped_tpu.env import fullorder
    from pympc_quadruped_tpu.models.command import Command
    from pympc_quadruped_tpu.models.gaits import Gaits
    from pympc_quadruped_tpu.models.mpc import MpcParams
    from pympc_quadruped_tpu.models.robots import aliengo

    if args.part == "14b":
        t0 = time.perf_counter()
        res = batch_viz_share(jax, jnp)
        print(json.dumps({"part": "14b", **res, "wall_s": round(time.perf_counter() - t0, 1),
                          "jax": jax.__version__}), flush=True)
        return 0

    p = FO_PARTS[args.part]
    B = B_MAIN
    tile = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), t)
    mpc = MpcParams(horizon=p["horizon"])
    robot = tile(aliengo())
    gait = tile(Gaits.by_name(p["gait"]))
    cmd = tile(Command.trot_forward(p["vx"]))
    dpos, dq, du = fullorder_jitter(B, p["seed"])
    s0 = jax.vmap(lambda r: fullorder.default_init_state(r))(robot)
    s0 = s0.replace(pos=s0.pos + dpos, q=s0.q + dq, u=s0.u + du)

    t0 = time.perf_counter()
    (state, _), m = jax.jit(lambda s: fullorder.rollout(
        robot, mpc, gait, cmd, num_ticks=FO_TICKS, state0=s, solver=p["solver"]))(s0)
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0

    as_torch = lambda a: torch.from_numpy(np.array(a))
    ok = fullorder_in_band({k: as_torch(v) for k, v in m.items()}, as_torch(state.pos[:, 0]),
                           p["band"]).numpy()
    print(json.dumps({"part": args.part, "scenarios": B, "ticks": FO_TICKS,
                      "in_band": int(ok.sum()),
                      "share": float(ok.mean()), "diverged_any": int(
                          np.asarray(m["diverged"]).any(axis=0).sum()),
                      "wall_s": round(wall, 1), "jax": jax.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
