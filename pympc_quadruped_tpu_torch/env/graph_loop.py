"""The closed-loop rollout loop shared by the environments.

JAX runs a rollout as one compiled ``lax.scan`` whose solve runs under a
scalar ``lax.cond``.  Here a :class:`GraphLoop` holds the loop's static
tensors (the env state, the full carry, a 0-d int32 device tick and the
(num_ticks, B) metric rows) and advances one tick at a time.  On a CUDA
device every non-solve tick replays one ``torch.cuda.CUDAGraph`` of that
tick, captured once per loop over the static tensors.  The solve tick (the
host gate ``controller.is_solve_tick``) runs its warm-started QP solve
eagerly, so the solver kernels launch, and count, outside any graph; the
rest of it replays from the graph segments of a :class:`..utils.tape.Tape`
that the loop records once, beside its graph (a solver with no eager call,
a parity solver, keeps the whole solve tick eager).  On CPU tensors every
tick runs eagerly.  On a card the host keeps at most one period queued
ahead of the card: each solve tick first waits until the card has run the
previous one, whose period's replays are still queued behind it.  So the
host enqueues a period while the card runs the one before, and the solve
tick's spans time the host's own enqueue, not a wait on a launch queue
filled many periods ahead.

The loop records its spans in :mod:`..utils.profiling`: the tick's layers
(``tick.controller``, ``tick.plant``, ``tick.rows``) and their children
count their kernel nodes while the plain graph is captured, and, for a
loop built ``traced`` while profiling is on, the tick is captured a second
time with a stamp kernel at each span's entry and exit (the traced graph,
sharing the plain graph's memory), which a step replays instead while a
``torch.profiler`` records.  A loop its caller steps is built ``traced``; a
``rollout()``, which builds its loop and runs it through in one call, only
while a profiler records.

An environment subclasses it with its ``_compute`` (one tick from
(state, carry) at the device tick) and hands :meth:`_start` its initial
state, carry and metric keys (and whether to capture the traced graph).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pympc_quadruped_tpu_torch.control import controller as ctrl
from pympc_quadruped_tpu_torch.tree import tree_map
from pympc_quadruped_tpu_torch.utils import profiling
from pympc_quadruped_tpu_torch.utils.tape import Tape


def _copy_into(dst, src):
    """Write every tensor leaf of ``src`` into the matching leaf of ``dst``."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


#: Plain graphs captured by :class:`GraphLoop` in this process: one per loop.
CAPTURES = 0


def capture_graph(body, warmup=None, pool=None) -> torch.cuda.CUDAGraph:
    """``body()`` captured in a CUDA graph (in memory pool ``pool``, if
    given), after two calls of ``warmup`` (``body`` unless given) on a side
    stream, in which spans do nothing.  A capture failure raises."""
    warmup = body if warmup is None else warmup
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), profiling.quiet():
        for _ in range(2):
            warmup()
    torch.cuda.current_stream().wait_stream(side)
    # keep_graph: the captured cudaGraph_t stays readable
    # (``raw_cuda_graph()``, e.g. to count its nodes) beside its executable.
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, pool=pool):
        body()
    graph.instantiate()
    return graph


@dataclass
class Buffers:
    """The loop's static tensors: the env state, the full carry, the absolute
    tick on the device and the (num_ticks, B) metric rows."""

    state: object
    carry: object
    tick: torch.Tensor
    metrics: dict


class GraphLoop:
    """One rollout call's loop: its buffers, the tick function and, on a
    CUDA device, the captured non-solve tick.  A subclass sets ``mpc``,
    ``tick0`` (the absolute first tick) and ``num_ticks`` (the metric rows,
    and the most ticks the loop takes), defines :meth:`_compute` and calls
    :meth:`_start`."""

    def _compute(self, state, carry, tick, solve: bool):
        """One closed-loop tick from (state, carry) at the device tick
        ``tick``: returns (state', carry', {metric: (B,) row})."""
        raise NotImplementedError

    def _start(self, state, carry, metric_keys, batch: int, device, traced: bool = True) -> None:
        """Allocate the buffers from copies of ``state`` and ``carry`` and,
        on a CUDA device, capture the non-solve tick (and, with ``traced``,
        its traced graph)."""
        self.next_tick = self.tick0
        self.traced = traced
        self.buf = Buffers(
            state=tree_map(torch.clone, state),
            carry=tree_map(torch.clone, carry),
            tick=torch.tensor(self.tick0, dtype=torch.int32, device=device),
            metrics={k: torch.zeros((self.num_ticks, batch), device=device,
                                    dtype=torch.bool if k == "diverged" else torch.float32)
                     for k in metric_keys},
        )
        self.loop_id = profiling.new_loop(device, self.tick0, self.num_ticks)
        self.cuda = torch.device(device).type == "cuda"
        self.graph = self.traced_graph = self.tape = None
        self._solved = None   # an event after the last solve tick, on a card
        if self.cuda:
            self._capture()

    def _tick(self, buf: Buffers, solve: bool) -> None:
        """One tick on ``buf``: every output written back into its static
        input, each metric stored at the tick's row, the device tick advanced."""
        state, carry, row = self._compute(buf.state, buf.carry, buf.tick, solve)
        with profiling.span("tick.rows"):
            idx = (buf.tick - self.tick0).long().reshape(1)
            for k, v in row.items():
                buf.metrics[k].index_copy_(0, idx, v[None])
            _copy_into(buf.state, state)
            _copy_into(buf.carry, carry)
            buf.tick.add_(1)

    def _capture(self) -> None:
        """Capture the non-solve tick over ``self.buf`` (the plain graph),
        after a warm-up over copies of the buffers (which leaves them as they
        were), its spans counting their kernel nodes; then, for a loop
        built ``traced`` while profiling is on, the traced graph; then,
        after a warm-up of the solve tick on the copies, the solve tick's
        tape."""
        global CAPTURES
        scratch = tree_map(torch.clone, self.buf)

        def counted():
            with profiling.count_nodes(self.loop_id):
                self._tick(self.buf, solve=False)

        def stamped():
            with profiling.emit_stamps(self.loop_id):
                self._tick(self.buf, solve=False)

        with profiling.tick(self.loop_id, self.tick0):
            with profiling.span("loop.capture"):
                self.graph = capture_graph(counted,
                                           warmup=lambda: self._tick(scratch, solve=False))
            CAPTURES += 1
            if self.traced and profiling.prepare_stamps(self.loop_id, self.buf.tick):
                with profiling.span("loop.capture"):
                    self.traced_graph = capture_graph(stamped, warmup=lambda: None,
                                                      pool=self.graph.pool())
                profiling.count("capture.traced")
            tape = Tape()
            with profiling.span("loop.capture"):
                if tape.warm_up(lambda: self._tick(scratch, solve=True)):
                    tape.record(lambda: self._tick(self.buf, solve=True),
                                pool=self.graph.pool())
                    self.tape = tape

    def step(self) -> None:
        """Advance one tick: the solve tick eagerly (on a card, its tape
        around the eager solve, once the card has run the previous solve
        tick), any other by replay (of the traced graph while a
        ``torch.profiler`` records)."""
        tick = self.next_tick
        if tick >= self.tick0 + self.num_ticks:
            raise IndexError(f"the loop was sized for {self.num_ticks} ticks")
        solve = ctrl.is_solve_tick(self.mpc, tick)
        period = tick - tick % self.mpc.iterations_between_mpc
        if solve and self._solved is not None:
            self._solved.synchronize()
        with profiling.tick(self.loop_id, period, events=solve and self.cuda) as traced:
            if solve:
                with profiling.solve_tick(self.cuda):
                    if self.tape is not None:
                        self.tape.play()
                    else:
                        self._tick(self.buf, solve=True)
                if self.cuda:
                    self._solved = torch.cuda.Event()
                    self._solved.record()
            elif self.graph is not None:
                graph = self.graph
                if traced and self.traced_graph is not None:
                    graph = self.traced_graph
                with profiling.span("tick.replay"):
                    graph.replay()
            else:
                self._tick(self.buf, solve=False)
        self.next_tick += 1

    def result(self, return_full_carry: bool = False):
        """``((env_state, carry), metrics)``: the carry is the controller
        carry, or with ``return_full_carry`` the whole loop carry (in
        estimator mode a tuple led by the controller carry)."""
        carry = self.buf.carry
        if isinstance(carry, tuple) and not return_full_carry:
            carry = carry[0]
        return (self.buf.state, carry), self.buf.metrics
