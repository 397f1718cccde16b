"""A closed loop's solve tick replayed from CUDA graphs around its QP solve.

A loop on a card (:class:`..env.graph_loop.GraphLoop`) replays its non-solve
tick from one captured graph and runs its solve tick eagerly, so that the QP
solver's kernels launch, and count, from the host on every solve tick.  Run
op by op, the rest of that tick (the controller, the reference trajectory and
the QP's operands, the plant and the metric rows) is ~560 launches at ~25 us
of host each (SRB, h=16, on an H100's host): the host then holds the card
back, and the QP waits for the model's ~430 launches before it starts.

A :class:`Tape` records the solve tick once, when the loop is built, and
replays it as a few CUDA graph segments.  Recording runs the tick under
stream capture; a call made through :func:`eager` (the warm-started solve,
``controller._warm_solve``) ends the segment being captured and becomes a
hole, and so does each span boundary (:func:`..profiling.taping`).
:meth:`Tape.play` replays the segments in order, opens and closes each span
where the tick did, so that the spans keep their samples and device times,
and calls each hole's function eagerly on the tensors its segment left,
copying what it returns into the static tensors the later segments read.

Before recording, :meth:`Tape.warm_up` runs the tick twice on a copy of the
loop's buffers, each hole answering zeros shaped as its ``like`` without
calling its function; a tick that makes no call through :func:`eager` (a
parity solver's) is not recorded.  The segments replay in capture order,
in the memory pool they are given (the loop's graph's): every tensor they
read is written earlier in the same play or lies outside the pool, so the
graph's replays between two plays may reuse their memory.  The tape holds
the holes' arguments and results for its life.  Playing it never
synchronises the host with the card.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

from pympc_quadruped_tpu_torch.tree import tree_map
from pympc_quadruped_tpu_torch.utils import profiling

# The tape that :func:`eager` feeds while one warms up or records.
_ACTIVE = None


def eager(fn, like, *args, **kwargs):
    """``fn(*args, **kwargs)``, whose results are tensors shaped as those
    of ``like`` (a tree of tensors); while a tape records, a hole that each
    of its plays calls eagerly with these arguments."""
    tape = _ACTIVE
    if tape is None:
        return fn(*args, **kwargs)
    return tape._hole(fn, like, args, kwargs)


class Tape:
    """One tick as graph segments, span marks and eager calls."""

    def __init__(self):
        # ("graph", g) | ("enter", name) | ("exit", name) | ("call", fn, args, kwargs, out)
        self.items = []
        self._mode = None
        self._graph = self._pool = self._stream = None
        self._holes = 0

    @contextlib.contextmanager
    def _active(self, mode):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("tape: another tape is warming up or recording")
        _ACTIVE, self._mode, self._holes = self, mode, 0
        try:
            yield
        finally:
            _ACTIVE, self._mode = None, None

    def warm_up(self, body) -> bool:
        """Run ``body()`` twice on a side stream, spans quiet, each hole
        answering zeros; returns whether it made any call through
        :func:`eager` (only then is there anything to record)."""
        side = self._side()
        with torch.cuda.stream(side), profiling.quiet(), self._active("warm"):
            for _ in range(2):
                body()
            holes = self._holes
        torch.cuda.current_stream().wait_stream(side)
        return holes > 0

    def record(self, body, pool) -> None:
        """Capture ``body()`` on a side stream into memory pool ``pool``,
        split at its holes and span boundaries; a capture failure raises."""
        self._pool = pool
        side = self._side()
        with torch.cuda.stream(side), self._active("record"), profiling.taping(self):
            self._begin()
            try:
                body()
            except BaseException:
                with contextlib.suppress(Exception):   # the capture may be invalidated
                    self._graph.capture_end()
                raise
            self._end()
        torch.cuda.current_stream().wait_stream(side)

    def _side(self) -> torch.cuda.Stream:
        """The side stream that warms up and records (one, so that the
        recording finds its libraries' handles and workspaces made), after
        the work queued on the current stream."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def play(self) -> None:
        """The recorded tick: its segments replayed, its spans opened and
        closed, its holes called."""
        spans = []
        try:
            for item in self.items:
                kind = item[0]
                if kind == "graph":
                    item[1].replay()
                elif kind == "enter":
                    span = profiling.span(item[1])
                    span.__enter__()
                    spans.append(span)
                elif kind == "exit":
                    spans.pop().__exit__(None, None, None)
                else:
                    _, fn, args, kwargs, out = item
                    tree_map(lambda dst, src: dst.copy_(src), out, fn(*args, **kwargs))
        finally:
            while spans:
                spans.pop().__exit__(None, None, None)

    # While recording: the holes, the spans' marks and the segments.

    def _hole(self, fn, like, args, kwargs):
        self._holes += 1
        if self._mode == "warm":
            return tree_map(torch.zeros_like, like)
        out = tree_map(torch.empty_like, like)   # static: the tape holds it
        self._split()
        self.items.append(("call", fn, args, kwargs, out))
        return out

    def mark(self, enter: bool, name: str) -> None:
        """A span's entry or exit while recording (``profiling.taping``)."""
        self._split()
        self.items.append(("enter" if enter else "exit", name))

    def _split(self) -> None:
        """End the segment being captured if it holds any node, and start
        the next."""
        if profiling.capture_nodes():
            self._end()
            self._begin()

    def _begin(self) -> None:
        # keep_graph: each segment stays countable (profiling.graph_nodes).
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._graph.capture_begin(pool=self._pool)

    def _end(self) -> None:
        graph, self._graph = self._graph, None
        empty = not profiling.capture_nodes()
        with warnings.catch_warnings():
            if empty:   # the tick's last segment: torch warns of an empty capture
                warnings.simplefilter("ignore")
            graph.capture_end()
        if not empty:
            graph.instantiate()
            self.items.append(("graph", graph))
