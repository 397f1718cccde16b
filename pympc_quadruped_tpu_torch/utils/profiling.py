"""Profiling and timing harness (port of ``utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of everything inside, written
  for TensorBoard;
- :func:`stage_timings`: per-call latency p50/p99 against the reference's
  real-time budgets (20 ms MPC solve, 1 ms tick; ref
  ``config/linear_mpc_configs.py:6-9``), each call timed with CUDA events
  when its tensors are on a card, else by the host clock;
- :func:`throughput`: pipelined calls with one synchronisation at the end.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

from pympc_quadruped_tpu_torch.tree import tree_map

MPC_BUDGET_MS = 20.0   # 50 Hz solve window (ref linear_mpc_configs.py:7)
TICK_BUDGET_MS = 1.0   # 1 kHz control tick (ref linear_mpc_configs.py:6)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the host and, where there is one, the card:
    ``with trace('tb'): fn(...)``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _on_cuda(args) -> bool:
    found = []
    tree_map(lambda t: found.append(t.is_cuda), tuple(args))
    return any(found)


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def stage_timings(fn: Callable, *args, iters: int = 20, warmup: int = 2,
                  budget_ms: float = MPC_BUDGET_MS) -> dict[str, float]:
    """Per-call latency distribution of ``fn(*args)``, each call run to its
    end on the device: CUDA events around the call when a tensor of
    ``args`` is on a card, else the host clock."""
    cuda = _on_cuda(args)
    for _ in range(warmup):
        fn(*args)
    _sync(cuda)
    ts = []
    for _ in range(iters):
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn(*args)
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.asarray(ts)
    return {
        "p50_ms": float(np.percentile(ts, 50)),
        "p99_ms": float(np.percentile(ts, 99)),
        "min_ms": float(ts.min()),
        "budget_ms": budget_ms,
        "within_budget": bool(np.percentile(ts, 99) < budget_ms),
    }


def throughput(fn: Callable, *args, iters: int = 20, warmup: int = 2,
               items_per_call: int = 1) -> dict[str, float]:
    """Steady-state throughput with pipelined dispatch: ``iters`` calls and
    one synchronisation at the end, by the host clock."""
    cuda = _on_cuda(args)
    for _ in range(warmup):
        fn(*args)
    _sync(cuda)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(cuda)
    dt = (time.perf_counter() - t0) / iters
    return {"ms_per_call": float(dt * 1e3), "items_per_s": float(items_per_call / dt)}
