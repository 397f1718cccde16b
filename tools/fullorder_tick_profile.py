#!/usr/bin/env python
"""Where the full-order environment's replayed non-solve tick spends its time.

    python tools/fullorder_tick_profile.py

On one CUDA card, at chip_smoke.py phase 11a's configuration (Aliengo,
h=16, TROTTING16, 1.0 m/s, 4096 jittered scenarios), after 200 ticks of
walking: the rollout's captured non-solve tick, and each of its layers
captured in a CUDA graph of its own (the observation, the controller's
non-solve step, the physics step and, inside it, the foot kinematics with
contact, the mass matrix, the bias forces and the 18x18 solve).  Each graph
is replayed 50 times and timed with CUDA events (median), and its kernel
and copy nodes are counted.  Then ``torch.profiler`` over 20 replays of
the whole tick: device time per tick by kernel name, the 12 largest.  One
JSON line, after the card's name and power limit.  Imports torch, numpy
and the port only; solves on no tick, so it builds no kernel.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from chip_smoke import B_MAIN, fullorder_setup, graph_nodes
from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.env import fullorder
from pympc_quadruped_tpu_torch.env.graph_loop import capture_graph
from pympc_quadruped_tpu_torch.ops import lie, rbd

WARM_TICKS = 200


def replay_ms(graph, reps=50) -> float:
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    mpc, robot, gait, cmd, state0 = fullorder_setup(dev, "11a", B_MAIN)
    # Walk on non-solve ticks only (no solver kernel is built): the held
    # forces stay the initial carry's, which is all the timing needs.
    loop = fullorder.RolloutLoop(robot, mpc, gait, cmd, WARM_TICKS + 1000, state0=state0,
                                 solver="riccati", tick0=1)
    for _ in range(WARM_TICKS):
        loop.graph.replay()
    torch.cuda.synchronize()

    state, carry, tick = loop.buf.state, loop.buf.carry, loop.buf.tick
    model, cp, dt = loop.model, loop.cp, loop.dt
    obs = fullorder.observe(robot, state)
    _, out = ctrl.step_gated(robot, mpc, gait, cmd, carry, obs, tick, False, "riccati")
    p_feet, v_feet, R = fullorder.foot_kinematics(robot, state)
    f_feet = fullorder.contact_forces(cp, p_feet, v_feet)
    H = rbd.mass_matrix(model, state.q)
    gen = torch.Generator(device=dev).manual_seed(0)
    rhs = torch.randn(state.u.shape, device=dev, generator=gen)
    parts = {
        "tick (the rollout's graph)": loop.graph,
        "observe": capture_graph(lambda: fullorder.observe(robot, state)),
        "controller step, no solve": capture_graph(lambda: ctrl.step_gated(
            robot, mpc, gait, cmd, carry, obs, tick, False, "riccati")),
        "physics_step": capture_graph(lambda: fullorder.physics_step(
            model, robot, cp, state, out.torques, dt)),
        "  foot kinematics + contact": capture_graph(lambda: fullorder.contact_forces(
            cp, *fullorder.foot_kinematics(robot, state)[:2])),
        "  mass_matrix (CRBA)": capture_graph(lambda: rbd.mass_matrix(model, state.q)),
        "  bias_forces (RNEA)": capture_graph(lambda: rbd.bias_forces(
            model, state.q, state.u, R, f_feet)),
        "  spd_solve (18x18)": capture_graph(lambda: rbd.spd_solve(H, rhs)),
        "  quaternion update": capture_graph(lambda: lie.quat_integrate(
            state.quat, state.u[:, :3], dt)),
    }
    record = {"card": card, "batch": B_MAIN, "parts": {}}
    for name, graph in parts.items():
        record["parts"][name] = dict(ms=replay_ms(graph), nodes=graph_nodes(graph))

    from torch.profiler import ProfilerActivity, profile
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            loop.graph.replay()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    total = sum(us for us, _ in by_name.values())
    record["profiled_device_us_per_tick"] = total / reps
    record["top_kernels"] = [
        dict(name=name[:120], us_per_tick=us / reps, launches_per_tick=n / reps,
             share=us / total)
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
