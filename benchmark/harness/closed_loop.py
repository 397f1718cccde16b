"""One run of a one-card closed-loop cell.

Set-up builds the cell's robots from the seed and the port's
``RolloutLoop`` sized for the whole run (warm-up, the window and the traced
periods), which captures the non-solve tick once, and runs the warm-up
periods.  The window's ticks are those of ``max_ticks_per_s``, a little
over the cell's fastest measured rate, so that the loop's per-tick metric
rows are about as many as the window fills; a program whose warm-up runs
faster gets a loop sized anew from that rate, still in set-up.  The window then steps whole 20-tick control periods until
``seconds`` have passed on the host clock: a CUDA event at each period's
start, after its eager solve tick and after its 19 replayed ticks.  It
ends with a ``synchronize``.  A reservoir drawn from the seed picks the
periods whose answers are checked; for those the harness copies the
sampled robots' state and carry around the solve tick and the first
replayed tick (:func:`.program.snapshot`).  With ``trace`` a few more
periods run under ``torch.profiler``.  The check runs after the port's
loop is freed.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.harness import check, program
from benchmark.traffic import generator


class Marks:
    """CUDA events on the card; host-clock marks elsewhere (CPU tests)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


#: A loop is built anew, in set-up, where the fastest warm-up period's
#: rate times REBUILD_AT passes the rate it was sized for; the new one is
#: sized for that rate times REBUILD_TO.
REBUILD_AT, REBUILD_TO = 1.1, 1.5


def warm_up(loop, periods: int, period: int, cuda: bool) -> float:
    """Step ``periods`` control periods; the fastest one's ticks per second."""
    fastest = 0.0
    for _ in range(periods):
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(period):
            loop.step()
        if cuda:
            torch.cuda.synchronize()
        fastest = max(fastest, period / (time.perf_counter() - t))
    return fastest


class Reservoir:
    """A uniform sample of ``k`` periods out of however many the window
    runs (Algorithm R), its choices drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self):
        """The slot the next period goes to, or None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


def periods(loop, limit: int, period: int, rows, probe, marks, reservoir, slots, ev,
            stop=lambda: False) -> int:
    """Step ``loop`` by whole control periods, at most ``limit`` of them and
    until ``stop()`` after a period, with the marks of each period in
    ``ev`` and, for the periods that ``reservoir`` takes, the sampled rows'
    snapshots in ``slots``; returns the periods stepped."""
    n = 0
    while n < limit:
        tick = loop.next_tick
        slot = reservoir.offer()
        if slot is not None:
            s0 = program.snapshot(loop, rows)
            probe.armed = True
        a = marks.mark()
        loop.step()
        b = marks.mark()
        if slot is not None:
            probe.armed = False
            s1 = program.snapshot(loop, rows)
        loop.step()
        if slot is not None:
            slots[slot] = dict(t=tick, s0=s0, s1=s1, s2=program.snapshot(loop, rows),
                               qp=probe.take(), loop=loop)
        for _ in range(period - 2):
            loop.step()
        ev.append((a, b, marks.mark()))
        n += 1
        if stop():
            break
    return n


def diverged_flags(slots, rows) -> None:
    """Each slot's (2, R) diverged flags of its two ticks, read from its
    loop's metric rows; drops the loop."""
    for slot in slots:
        if slot is not None and "loop" in slot:
            loop = slot.pop("loop")
            i = slot["t"] - loop.tick0
            slot["bad"] = torch.stack([loop.buf.metrics["diverged"][i + j].index_select(0, rows)
                                       for j in (0, 1)])


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, batch: int | None = None) -> dict:
    """The record of one run: timings, counters, the trace's reduction, the
    device's memory peak, the check's per-answer numbers, and what they
    were judged from (the draws, the sampled rows, the start and the
    checked periods' slots).  ``batch`` replaces the configuration's in
    the CPU tests."""
    from pympc_quadruped_tpu_torch.env import graph_loop
    from pympc_quadruped_tpu_torch.ops.qp import admm_cuda, riccati_cuda

    cuda = torch.device(device).type == "cuda"
    B = batch or cfg["batch"]
    period = cfg["mpc"]["iterations_between_mpc"]
    draws = generator.draw(mix, B, seed)
    pick = generator.rng_for(seed, 1)
    rows_np = np.sort(pick.choice(B, size=min(cell["check"]["rows"], B), replace=False))
    rows = torch.as_tensor(rows_np, device=device)
    warm = cell["warmup_periods"] * period
    traced = cell["trace_periods"] if trace else 0
    launches0 = (riccati_cuda.LAUNCHES, dict(admm_cuda.LAUNCHES))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rate = cell["max_ticks_per_s"]
    parts = {"imports": time.time() - t_start, "build": 0.0, "warm_up": 0.0}
    while True:
        window_periods = math.ceil(seconds * rate / period) + 1
        t = time.time()
        loop = program.build(cfg, mix, draws, warm + (window_periods + traced) * period, device)
        start = program.snapshot(loop, rows)["state"]
        parts["build"] += time.time() - t
        t = time.time()
        fastest = warm_up(loop, cell["warmup_periods"], period, cuda)
        parts["warm_up"] += time.time() - t
        if fastest * REBUILD_AT <= rate:
            break
        rate = fastest * REBUILD_TO
        del loop
    probe = program.SolveProbe(cfg["solver"], rows)
    try:
        setup_s = time.time() - t_start
        marks = Marks(cuda)
        reservoir = Reservoir(cell["check"]["periods"], pick)
        slots = [None] * reservoir.k
        ev = []
        t0 = time.perf_counter()
        n = periods(loop, window_periods, period, rows, probe, marks, reservoir, slots, ev,
                    stop=lambda: time.perf_counter() - t0 >= seconds)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if n == window_periods:
            raise RuntimeError(f"the window outran the {window_periods} periods that its "
                               "warm-up foresaw")
        rec = dict(
            setup_s=setup_s, wall_s=wall, periods=n, batch=B, ticks=n * period * B,
            loop_ticks_per_s=rate, setup_parts=parts,
            period_ms=[marks.ms(a, c) for a, _, c in ev],
            solve_ms=[marks.ms(a, b) for a, b, _ in ev],
            replay_ms=[marks.ms(b, c) / (period - 1) for _, b, c in ev],
            launches={"riccati_admm": riccati_cuda.LAUNCHES - launches0[0],
                      **{k: v - launches0[1][k] for k, v in admm_cuda.LAUNCHES.items()}},
            captures=graph_loop.CAPTURES, solve_calls=probe.calls,
        )
        if cuda and loop.graph is not None:
            from benchmark.harness import trace as tr

            rec["graph_nodes"] = tr.graph_nodes(loop.graph)
        if traced:
            rec.update(_traced(loop, traced, period, cuda))
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        diverged_flags(slots, rows)
    finally:
        probe.close()
    slots = [s for s in slots if s is not None]
    del loop
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    robot_rows = program.robot_rows(cfg, draws)
    per = check.judge(cfg, mix, cfg["solver"], robot_rows, draws, rows_np, start, slots, device)
    rec["check_s"] = time.perf_counter() - t_check
    rec["per_answer"] = per
    rec["checked_ticks"] = [s["t"] for s in slots]
    rec.update(draws=draws, rows=rows_np, start=start, slots=slots)
    return rec


def _traced(loop, periods: int, period: int, cuda: bool) -> dict:
    """``periods`` more control periods under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    marks = Marks(cuda)
    with profile(activities=acts) as prof:
        a = marks.mark()
        for _ in range(periods * period):
            loop.step()
        b = marks.mark()
        if cuda:
            torch.cuda.synchronize()
    dev = tr.device_intervals(prof)
    merged = tr.union(dev)
    return dict(
        window_s=marks.ms(a, b) * 1e-3,
        busy_s=sum(e - s for s, e in merged) * 1e-6,
        kernels=tr.kernel_table(dev),
        idle_gaps=tr.idle_gaps(merged, tr.host_intervals(prof)),
        traced_periods=periods,
    )
