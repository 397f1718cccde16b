#!/usr/bin/env python
"""The JAX package's in-band share on the full-order trots of chip_smoke.py phase 11.

    JAX_PLATFORMS=cpu python tools/fullorder_reference_share.py --part 11a

Runs the reference ``env/fullorder.rollout`` on the CPU over the 4096
jittered scenarios that ``chip_smoke.py`` phase 11 runs through the port on
the card (the same numpy recipe and seed), and prints one JSON line with
the share of scenarios inside the part's band:

- ``11a``: Aliengo, h=16, TROTTING16, 1.0 m/s, ``solver="riccati"``, 1500
  ticks; band of tests/test_h16_config.py:99-126;
- ``11b``: Aliengo, h=10, TROTTING10, 1.2 m/s, the default ``admm_fast``,
  1500 ticks (bench.py:757's configuration); band of
  tests/test_rbd.py:400-425.

The parts, the jitter (tests/test_rbd.py:35-65's) and the band are
chip_smoke.py's own (``FO_PARTS``, ``fullorder_jitter``,
``fullorder_in_band``), so both frameworks run and judge the same
scenarios.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from chip_smoke import B_MAIN, FO_PARTS, FO_TICKS, fullorder_in_band, fullorder_jitter


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=sorted(FO_PARTS), required=True)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pympc_quadruped_tpu.env import fullorder
    from pympc_quadruped_tpu.models.command import Command
    from pympc_quadruped_tpu.models.gaits import Gaits
    from pympc_quadruped_tpu.models.mpc import MpcParams
    from pympc_quadruped_tpu.models.robots import aliengo

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
