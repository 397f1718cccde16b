"""The closed-loop tick: controller + SRB physics, batched.

One tick is exactly the JAX package's closed-loop benchmark tick
(``bench.py:849-864``): observe, ``controller.step_batch``, world-frame
swing targets ``pos + R_base @ pos_targets``, ``srb_env.physics_step``.
"""
from __future__ import annotations

from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.env import srb_env


def run_ticks(robot, mpc, gait, cmd, carry, state, tick0: int, n_ticks: int,
              solver: str = ctrl.DEFAULT_SOLVER):
    """Advance ``n_ticks`` ticks from the absolute tick ``tick0`` with the
    controller's ``solver`` (any of ``controller.SOLVERS``; ``"admm_fast"``
    by default).

    Returns (carry, state, out): the controller carry and SRB state after
    the last tick, and that tick's ``ControllerOutput``."""
    out = None
    for tick in range(tick0, tick0 + n_ticks):
        obs = srb_env.observe(robot, state)
        carry, out = ctrl.step_batch(robot, mpc, gait, cmd, carry, obs, tick,
                                     solver=solver)
        swing_pos_world = state.pos[:, None, :] + (
            out.kin.R_base[:, None] @ out.pos_targets[..., None]
        )[..., 0]
        state = srb_env.physics_step(robot, mpc, state, out.contact_forces,
                                     out.swing_states, swing_pos_world)
    return carry, state, out
