"""Profiling and timing harness (port of ``utils/profiling.py``), and the
port's own spans and counters.

- :func:`trace`: a ``torch.profiler`` trace of everything inside, written
  for TensorBoard;
- :func:`stage_timings`: per-call latency p50/p99 against the reference's
  real-time budgets (20 ms MPC solve, 1 ms tick; ref
  ``config/linear_mpc_configs.py:6-9``), each call timed with CUDA events
  when its tensors are on a card, else by the host clock;
- :func:`throughput`: pipelined calls with one synchronisation at the end;
- :func:`span`, :func:`count`, :func:`snapshot`, :func:`reset` and
  :func:`set_enabled`: the registry of the closed loop's spans and
  counters, in two levels;
- :func:`graph_nodes`: the nodes of a captured CUDA graph by type.

**Level 1, on unless** :func:`set_enabled` ``(False)``.  A span records its
host start and duration (``time.perf_counter_ns``), its self time (the
duration less its child spans'), its parent span, the id of the loop it ran
in and the absolute tick of that loop's control period (its solve tick: the
identifier one period's spans share).  On an eager tick of a loop on a card
it also records a pair of CUDA timing events on the current stream, whose
``elapsed_time`` is folded in once ``query()`` says both are done, never by
synchronising.  On a stretch the host holds back, that device time includes
the card's wait for the host's launches: what the part costs the period.
While :class:`..env.graph_loop.GraphLoop` captures its non-solve tick, a
span counts the kernel nodes it adds to the graph instead; during the
capture's warm-up calls it does nothing.  While the loop records its solve
tick's tape (:mod:`.tape`), a span marks its entry and exit on the tape
(:func:`taping`), and each play of the tape opens and closes the span
there, so the solve tick's spans record as an eager tick's do.  Samples go into rings of the
newest :data:`RING` per span name, in memory, and outlive the loop that
made them.  A span with no loop's tick current, such as the sweep's
(``launch.join``, ``mesh.reduce``, ``ckpt.*`` in :mod:`..parallel`),
records the same sample with no loop and no period, which
:func:`snapshot` gives as loop -1 and tick -1, and no events.  Counters
(:func:`count`) are plain sums, kept only while level 1 is on.
:func:`snapshot` synchronises once and returns them as host arrays, with the
counters and each loop's node counts and stamps; nothing is written to
disk.

**Level 2, on while a** ``torch.profiler`` **records** (:func:`recording`,
checked once per ``GraphLoop.step``, and by each span outside a tick;
:func:`trace` starts one): each span also opens a
record of its name (``torch._C._profiler._RecordFunctionFast``, function
scope), so the program's spans sit in the profiler's host trace beside the
device operations, on its clock; ``record_function``'s user scope would also
lay each span on the device's timeline, where a busy share counts it as
device work.  Each solve tick runs under
``torch.cuda.set_sync_debug_mode("warn")`` and adds its synchronising calls
to counter ``solve.syncs`` (``solve.traced_ticks`` counts those ticks); and
each replayed tick runs the loop's traced graph, the non-solve tick
captured again with a one-thread kernel (``csrc/stamp.cu``) at each span's
entry and exit that writes the card's ``%globaltimer`` into an int64 row
per tick, which the registry owns.  A loop captures its traced graph only
where it can be traced (``GraphLoop``'s ``traced``): a loop that its caller
steps, or a ``rollout()`` called while a profiler records; each such
capture adds one to counter ``capture.traced``.

The counters the kernels' wrappers and the loop keep
(``admm_cuda.LAUNCHES``, ``riccati_cuda.LAUNCHES``,
``graph_loop.CAPTURES``) live in their modules, where their readers read
them; this module imports nothing from ``env/`` or ``ops/``, so neither
:func:`snapshot` nor :func:`reset` sees them.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time
import warnings
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


# ---------------------------------------------------------------------------
# The closed loop's spans and counters
# ---------------------------------------------------------------------------

#: Samples kept per span name, the newest: a long stretch of replays keeps
#: only its last RING (``tick.replay`` at 250-600 a second on an H100).
RING = 4096
#: Loops whose node counts and stamps the registry keeps, the newest.
LOOPS_KEPT = 8
#: What torch's sync debug mode warns of a synchronising call.
SYNC_WARNING = "called a synchronizing CUDA operation"

# What a span does: record a sample (and, on an eager tick on a card, a pair
# of events), nothing (a capture's warm-up calls), count the kernel nodes it
# adds to the graph being captured, launch a stamp kernel at its ends, or
# mark its ends on the tape being recorded (utils/tape.py).
_RECORD, _QUIET, _COUNT, _STAMP, _TAPE = range(5)
# A sample: [loop, period, start_ns, host_ns, self_ns, parent, device_ms].
_DEVICE_MS = 6


@functools.cache
def _libcuda() -> ctypes.CDLL:
    return ctypes.CDLL("libcuda.so.1")


def _node_types(graph: ctypes.c_void_p, kinds: dict | None = None) -> list[int]:
    """The ``CUgraphNodeType`` of each node of ``graph`` (``cuGraphGetNodes``);
    ``kinds`` caches them by node across calls on a growing graph."""
    cu = _libcuda()
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("profiling: cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("profiling: cuGraphGetNodes failed")
    kinds = {} if kinds is None else kinds
    kind = ctypes.c_int(-1)
    for node in nodes[:n.value]:
        if node not in kinds:
            cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
            kinds[node] = kind.value
    return [kinds[node] for node in nodes[:n.value]]


_NODE_NAMES = {0: "kernel", 1: "memcpy", 2: "memset"}


def _capturing() -> ctypes.c_void_p:
    """The graph the current stream is capturing into
    (``cuStreamGetCaptureInfo_v2``)."""
    status, graph = ctypes.c_int(0), ctypes.c_void_p()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = _libcuda().cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status), None,
                                              ctypes.byref(graph), None, None)
    if rc != 0 or status.value != 1:   # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("profiling: the current stream is not capturing a graph")
    return graph


def capture_nodes() -> int:
    """Nodes of every type in the graph the current stream is capturing
    into."""
    n = ctypes.c_size_t(0)
    if _libcuda().cuGraphGetNodes(_capturing(), None, ctypes.byref(n)) != 0:
        raise RuntimeError("profiling: cuGraphGetNodes failed")
    return n.value


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> dict:
    """Node counts by type (``kernel``, ``memcpy``, ``memset``, else
    ``type<n>``) of a graph captured with ``keep_graph=True``."""
    counts = {}
    for k in _node_types(ctypes.c_void_p(int(graph.raw_cuda_graph()))):
        name = _NODE_NAMES.get(k, f"type{k}")
        counts[name] = counts.get(name, 0) + 1
    return counts


class _Loop:
    """What the registry keeps of one loop: where it runs, its ticks, the
    kernel nodes of each span of its captured tick, and its stamps."""

    def __init__(self, device: str, tick0: int, num_ticks: int):
        self.device, self.tick0, self.num_ticks = device, tick0, num_ticks
        self.nodes = {}      # span name -> kernel nodes it adds to the plain graph
        self.bounds = 0      # span entries and exits in the captured tick
        self.layout = []     # (name, parent, entry slot, exit slot) of the traced graph
        self.stamps = None   # (num_ticks, bounds) int64 on the card
        self.row = self.tick = self.lib = None
        self.slot = 0
        self._kinds = {}     # graph node -> its CUgraphNodeType

    def kernel_nodes(self) -> int:
        """Kernel nodes of the graph the current stream is capturing into."""
        return _node_types(_capturing(), self._kinds).count(0)   # CU_GRAPH_NODE_TYPE_KERNEL

    def stamp(self) -> int:
        """Launch the stamp kernel at the next slot on the current stream;
        the tick's first stamp reads the device tick for the row."""
        slot = self.slot
        if slot >= self.bounds:
            raise RuntimeError("profiling: the traced tick enters more spans than the plain one")
        rc = self.lib.stamp_launch(self.tick.data_ptr(), self.tick0, self.row.data_ptr(),
                                   int(slot == 0), self.stamps.data_ptr(), self.num_ticks,
                                   self.bounds, slot, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"stamp launch failed: CUDA error {rc}")
        self.slot += 1
        return slot


class _Registry:
    """The process's spans, counters and loops (module state: the samples
    outlive the loops that made them)."""

    def __init__(self):
        self.enabled = True
        self.next_loop = 0
        self.free = []          # completed timing events, for reuse
        self.reset()

    def reset(self) -> None:
        self.rings = {}
        self.counters = {}
        self.loops = {}
        self.pending = collections.deque()   # (sample, start event, end event)
        self.stack = []
        self.mode, self.capture = _RECORD, None
        self.loop = self.period = None
        self.events = self.level2 = False

    def event(self) -> "torch.cuda.Event":
        ev = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def fold(self) -> None:
        """Device times of the spans whose events are done, oldest first;
        stops at the first not done (``query``, no synchronisation)."""
        pending = self.pending
        while pending and pending[0][2].query():
            sample, a, b = pending.popleft()
            sample[_DEVICE_MS] = a.elapsed_time(b)
            self.free += (a, b)


_R = _Registry()


class _Span:
    __slots__ = ("name", "mode", "parent", "t0", "child_ns", "ev", "fn", "mark")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        r = _R
        self.mode = mode = r.mode
        if mode == _QUIET:
            return self
        if mode == _TAPE:
            r.capture.mark(True, self.name)
            return self
        stack = r.stack
        self.parent = stack[-1].name if stack and stack[-1].mode == mode else None
        stack.append(self)
        if mode == _COUNT:
            self.mark = r.capture.kernel_nodes()
        elif mode == _STAMP:
            self.mark = r.capture.stamp()
        else:
            self.fn = None
            if r.level2 if r.loop is not None else recording():
                self.fn = torch._C._profiler._RecordFunctionFast(self.name)
                self.fn.__enter__()
            self.ev = r.event() if r.events else None
            self.child_ns = 0
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        mode = self.mode
        if mode == _QUIET:
            return False
        r = _R
        if mode == _TAPE:
            r.capture.mark(False, self.name)
            return False
        stack = r.stack
        stack.pop()
        if mode == _COUNT:
            cap = r.capture
            cap.nodes[self.name] = cap.nodes.get(self.name, 0) + cap.kernel_nodes() - self.mark
            cap.bounds += 2
            return False
        if mode == _STAMP:
            cap = r.capture
            cap.layout.append((self.name, self.parent, self.mark, cap.stamp()))
            return False
        end = r.event() if self.ev is not None else None
        dur = time.perf_counter_ns() - self.t0
        if stack and stack[-1].mode == _RECORD:
            stack[-1].child_ns += dur
        sample = [r.loop, r.period, self.t0, dur, dur - self.child_ns, self.parent, float("nan")]
        ring = r.rings.get(self.name)
        if ring is None:
            ring = r.rings[self.name] = collections.deque(maxlen=RING)
        ring.append(sample)
        if end is not None:
            r.pending.append((sample, self.ev, end))
        if self.fn is not None:
            self.fn.__exit__(None, None, None)
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records one sample of the span ``name`` (module
    docstring); a no-op after ``set_enabled(False)``."""
    return _Span(name) if _R.enabled else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``; a no-op after ``set_enabled(False)``."""
    if _R.enabled:
        _R.counters[name] = _R.counters.get(name, 0) + n


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process (level 2)."""
    return torch._C._autograd._profiler_enabled()


def set_enabled(flag: bool) -> None:
    """Turn level 1 (and with it level 2) on or off; off, every span and
    counter is a no-op that checks one bool, and a loop built then has no
    traced graph."""
    _R.enabled = bool(flag)


def reset() -> None:
    """Clear the registry's samples, counters and loops."""
    _R.reset()


class _Tick:
    __slots__ = ("loop", "period", "events")

    def __init__(self, loop, period, events):
        self.loop, self.period, self.events = loop, period, events

    def __enter__(self) -> bool:
        r = _R
        if not r.enabled:
            return False
        r.loop, r.period, r.events = self.loop, self.period, self.events
        if self.events and r.pending:
            r.fold()
        r.level2 = recording()
        return r.level2

    def __exit__(self, *exc):
        r = _R
        r.loop = r.period = None
        r.events = r.level2 = False
        return False


def tick(loop: int, period: int, events: bool = False) -> _Tick:
    """``with tick(loop, period, events) as traced:`` one step of loop
    ``loop`` in the control period whose solve tick is ``period``; its spans
    record CUDA events where ``events`` (an eager tick on a card).  Yields
    whether level 2 is on (a ``torch.profiler`` records)."""
    return _Tick(loop, period, events)


@contextlib.contextmanager
def solve_tick(cuda: bool):
    """The eager solve tick: span ``tick.solve``; under level 2 on a card,
    its synchronising calls are counted (``solve.syncs``,
    ``solve.traced_ticks``) under torch's sync debug mode, whose previous
    mode is restored after."""
    with span("tick.solve"):
        if not (cuda and _R.level2):
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        syncs = 0
        for w in caught:
            if SYNC_WARNING in str(w.message):
                syncs += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        count("solve.syncs", syncs)
        count("solve.traced_ticks")


def new_loop(device, tick0: int, num_ticks: int) -> int:
    """Register a loop on ``device`` over ticks ``[tick0, tick0 +
    num_ticks)``; returns its id (increasing).  The registry keeps the
    newest :data:`LOOPS_KEPT`."""
    r = _R
    r.next_loop += 1
    r.loops[r.next_loop] = _Loop(str(device), int(tick0), int(num_ticks))
    while len(r.loops) > LOOPS_KEPT:
        del r.loops[min(r.loops)]
    return r.next_loop


@contextlib.contextmanager
def _mode(mode, capture=None):
    r = _R
    saved = r.mode, r.capture
    r.mode, r.capture = mode, capture
    try:
        yield
    finally:
        r.mode, r.capture = saved


def quiet():
    """Spans inside do nothing: a capture's warm-up calls."""
    return _mode(_QUIET)


def count_nodes(loop: int):
    """Inside a graph capture of loop ``loop``'s tick: each span counts the
    kernel nodes it adds (``snapshot()["loops"][loop]["nodes"]``)."""
    cap = _R.loops.get(loop)
    if not _R.enabled or cap is None:
        return _NULL
    cap.nodes, cap.bounds = {}, 0
    return _mode(_COUNT, cap)


def prepare_stamps(loop: int, tick: torch.Tensor) -> bool:
    """Allocate loop ``loop``'s stamps, one int64 per span entry and exit of
    its counted tick for each of its ticks, and load the stamp kernel;
    ``tick`` is the loop's 0-d int32 device tick.  False (no traced graph)
    where profiling is off or no span was counted."""
    from pympc_quadruped_tpu_torch import _build

    cap = _R.loops.get(loop)
    if not _R.enabled or cap is None or not cap.bounds:
        return False
    cap.stamps = torch.zeros((cap.num_ticks, cap.bounds), dtype=torch.int64,
                             device=tick.device)
    cap.row = torch.zeros((1,), dtype=torch.int32, device=tick.device)
    cap.tick, cap.lib = tick, _build.load("stamp").lib
    # One launch that writes nothing (no rows), so the kernel's module is
    # loaded before the capture.
    rc = cap.lib.stamp_launch(tick.data_ptr(), cap.tick0, cap.row.data_ptr(), 0,
                              cap.stamps.data_ptr(), 0, cap.bounds, 0,
                              torch.cuda.current_stream(tick.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stamp launch failed: CUDA error {rc}")
    return True


def taping(tape):
    """While ``tape`` (a :class:`..tape.Tape`) records a tick: each span
    marks its entry and exit on it instead of recording."""
    return _mode(_TAPE, tape)


def emit_stamps(loop: int):
    """Inside the traced graph's capture of loop ``loop``'s tick: each span
    launches the stamp kernel at its entry and exit."""
    cap = _R.loops[loop]
    cap.layout, cap.slot = [], 0
    return _mode(_STAMP, cap)


def _columns(samples) -> dict:
    none = lambda v: -1 if v is None else v
    return {"loop": np.array([none(s[0]) for s in samples], np.int64),
            "tick": np.array([none(s[1]) for s in samples], np.int64),
            "start_ns": np.array([s[2] for s in samples], np.int64),
            "host_ns": np.array([s[3] for s in samples], np.int64),
            "self_ns": np.array([s[4] for s in samples], np.int64),
            "parent": [s[5] for s in samples],
            "device_ms": np.array([s[_DEVICE_MS] for s in samples], np.float64)}


def snapshot() -> dict:
    """Everything the registry holds, as host arrays, after one
    synchronisation that lets every pending device time be folded in:

    - ``spans``: per span name, columns ``loop`` and ``tick`` (the loop id and
      its control period's solve tick, -1 outside a loop), ``start_ns``,
      ``host_ns``, ``self_ns``, ``parent`` (a list) and ``device_ms`` (NaN
      where no events were recorded);
    - ``counters``: the registry's own (:func:`count`), not the modules'
      counters (``admm_cuda.LAUNCHES`` and the like);
    - ``loops``: per loop id, its ``device``, ``tick0``, ``num_ticks``, the
      kernel ``nodes`` of each span in its plain graph, and where it has a
      traced graph its stamp ``layout`` (name, parent, entry column, exit
      column) and ``stamps`` ((num_ticks, columns) ns of ``%globaltimer``, 0
      in a row no traced replay wrote)."""
    r = _R
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    r.fold()
    loops = {}
    for i, lp in r.loops.items():
        loops[i] = {"device": lp.device, "tick0": lp.tick0, "num_ticks": lp.num_ticks,
                    "nodes": dict(lp.nodes), "layout": list(lp.layout),
                    "stamps": None if lp.stamps is None else lp.stamps.cpu().numpy()}
    return {"spans": {name: _columns(list(ring)) for name, ring in r.rings.items()},
            "counters": dict(r.counters), "loops": loops}
