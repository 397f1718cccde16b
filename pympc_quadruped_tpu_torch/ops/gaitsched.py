"""Pure gait phase machinery (port of ``ops/gaitsched.py``).

Every quantity is a function of ``(tick, GaitParams, MpcParams)``; the gait
may carry leading scenario axes.  ``tick`` is the shared tick: a Python int,
or a 0-d integer tensor on the gait's device (the device tick that a
captured CUDA graph of the rollout tick reads), with the same results.
Semantics as in the JAX module (ref ``linear_mpc/gait.py:76-150``):

- ``iteration = floor(tick / iters) mod num_segments`` and
  ``phase = (tick mod (iters * num_segments)) / (iters * num_segments)``,
  both in integer floor semantics;
- the gait table looks one segment ahead (slot ``i`` uses segment
  ``(i + 1 + iteration) mod num_segments``);
- window normalization is strict ``>`` at the window end;
- swing/stance times use ``dt_gait`` (0.02 s), not ``dt_predict``.
"""
from __future__ import annotations

import torch

from pympc_quadruped_tpu_torch.models.gaits import GaitParams
from pympc_quadruped_tpu_torch.models.mpc import MpcParams


def phase_of_tick(gait: GaitParams, mpc: MpcParams, tick):
    """Returns (iteration, phase): int32 segment index and cycle phase in [0,1).
    ``//`` and ``torch.remainder`` floor on a Python int and on a tensor
    alike, as JAX's ``//`` and ``%`` do."""
    iters = mpc.iterations_between_mpc
    iteration = torch.remainder(tick // iters, gait.num_segments)
    period = iters * gait.num_segments
    phase = torch.remainder(tick, period).float() / period.float()
    return iteration, phase


def gait_table(gait: GaitParams, mpc: MpcParams, tick) -> torch.Tensor:
    """(..., horizon*4) stance table, 1 stance / 0 swing, row-major over
    (horizon step, leg)."""
    iteration, _ = phase_of_tick(gait, mpc, tick)
    n = gait.num_segments[..., None]
    steps = torch.arange(mpc.horizon, dtype=torch.int32, device=n.device)
    seg = torch.remainder(steps + 1 + iteration[..., None], n)        # (...,h)
    cur = seg[..., :, None] - gait.stance_offsets[..., None, :]       # (...,h,4)
    cur = torch.where(cur < 0, cur + n[..., None], cur)
    table = (cur < gait.stance_durations[..., None, :]).float()
    return table.reshape(table.shape[:-2] + (mpc.horizon * 4,))


def _window_state(phase, offsets_n, durations_n):
    """Shared swing/stance normalization; a zero-duration window yields 0."""
    state = phase - offsets_n
    state = torch.where(state < 0.0, state + 1.0, state)
    pos_dur = durations_n > 0.0
    safe_dur = torch.where(pos_dur, durations_n, torch.ones_like(durations_n))
    out = state / safe_dur
    return torch.where((state > durations_n) | ~pos_dur, torch.zeros_like(out), out)


def _normalized_windows(gait: GaitParams):
    num = gait.num_segments.float()[..., None]
    return (gait.stance_offsets.float() / num,
            gait.stance_durations.float() / num)


def swing_state(gait: GaitParams, mpc: MpcParams, tick) -> torch.Tensor:
    """(...,4) normalized swing phase per leg: 0 = not swinging, (0,1] = progress."""
    _, phase = phase_of_tick(gait, mpc, tick)
    offsets_n, durations_n = _normalized_windows(gait)
    swing_offsets = offsets_n + durations_n
    swing_offsets = torch.where(swing_offsets > 1.0, swing_offsets - 1.0, swing_offsets)
    return _window_state(phase[..., None], swing_offsets, 1.0 - durations_n)


def stance_state(gait: GaitParams, mpc: MpcParams, tick) -> torch.Tensor:
    """(...,4) normalized stance phase per leg: 0 = not in stance."""
    _, phase = phase_of_tick(gait, mpc, tick)
    offsets_n, durations_n = _normalized_windows(gait)
    return _window_state(phase[..., None], offsets_n, durations_n)


def swing_time(gait: GaitParams, mpc: MpcParams) -> torch.Tensor:
    """Total swing duration in seconds."""
    return mpc.dt_gait * gait.total_swing_segments.float()


def stance_time(gait: GaitParams, mpc: MpcParams) -> torch.Tensor:
    """Total stance duration in seconds."""
    return mpc.dt_gait * gait.total_stance_segments.float()
