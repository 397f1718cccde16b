"""The port's spans and counters (``utils/profiling.py``) on the CPU: the
registry itself (nesting, parents, self time, the rings, ``reset``,
``set_enabled``), the spans of the closed loop's ticks in both envs with
``admm_fast`` and ``riccati``, that they change no number of the loop and
cover every operation of a tick, the profiler's view of them, and the
benchmark's readers of them (``benchmark/metrics/``), which find nothing to
read on a CPU record; and the solve tick's tape (``utils/tape.py``): its
spans' marks, its eager calls, and its logic with a stand-in for stream
capture.  The graph-capture half (node counts, the traced graph's stamps,
sync counting, the tape's real capture) runs on a card:
tests/test_torch_cuda.py."""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness import manifest
from benchmark.metrics import _spans
from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.env import fullorder, srb_env
from pympc_quadruped_tpu_torch.estimation import kf
from pympc_quadruped_tpu_torch.models import Command, Gaits, aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.utils import profiling
from pympc_quadruped_tpu_torch.utils import tape as tape_lib

PERIOD = 20
LAYERS = ("tick.controller", "tick.plant", "tick.rows")
TICK_SPANS = {"tick.solve", "tick.controller", "ctrl.pre", "solve.model", "solve.qp",
              "ctrl.post", "tick.plant", "tick.rows"}
READERS = ("solve_host_ms", "solve_syncs", "solve_ms.controller", "solve_ms.model",
           "solve_ms.qp", "solve_ms.plant", "replay_launch_us", "replay_ms.controller",
           "replay_ms.plant", "replay_ms.rows", "replay_ms.crba", "replay_ms.rnea",
           "replay_nodes.controller", "replay_nodes.plant", "replay_nodes.rows", "capture_ms")


@pytest.fixture(autouse=True)
def registry():
    profiling.reset()
    yield
    profiling.set_enabled(True)
    profiling.reset()


def _loop(plant, solver, ticks=60, b=3, **kw):
    d = "cpu"
    mpc, robot = default_mpc_params(10, device=d), tree.tile(aliengo(d), b)
    gait, cmd = tree.tile(Gaits.trotting10(d), b), tree.tile(Command.trot_forward(0.5, d), b)
    env = srb_env if plant == "srb" else fullorder
    return env.RolloutLoop(robot, mpc, gait, cmd, ticks, solver=solver, **kw)


def _run(loop, ticks):
    for _ in range(ticks):
        loop.step()
    return loop


def test_spans_nest_with_parents_and_self_time():
    with profiling.span("outer"):
        with profiling.span("inner"):
            torch.ones(3).sum()
        with profiling.span("inner"):
            pass
    snap = profiling.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["parent"] == [None] and inner["parent"] == ["outer", "outer"]
    assert outer["self_ns"][0] == outer["host_ns"][0] - inner["host_ns"].sum()
    assert (inner["self_ns"] == inner["host_ns"]).all()
    assert outer["start_ns"][0] <= inner["start_ns"][0] <= inner["start_ns"][1]
    assert (outer["loop"] == -1).all() and (outer["tick"] == -1).all()
    assert np.isnan(outer["device_ms"]).all()


def test_ring_keeps_the_newest_samples(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    for period in range(20):
        with profiling.tick(1, period):
            with profiling.span("x"):
                pass
    assert profiling.snapshot()["spans"]["x"]["tick"].tolist() == list(range(12, 20))


def test_counters_and_reset():
    profiling.count("a")
    profiling.count("a", 2)
    counters = profiling.snapshot()["counters"]
    assert counters["a"] == 3
    with profiling.span("s"):
        pass
    profiling.reset()
    snap = profiling.snapshot()
    assert "a" not in snap["counters"] and not snap["spans"] and not snap["loops"]


def test_disabled_spans_are_noops():
    profiling.set_enabled(False)
    assert profiling.span("a") is profiling.span("b")
    with profiling.tick(1, 0) as traced:
        with profiling.span("a"):
            pass
    _run(_loop("srb", "riccati", ticks=21), 21)
    assert not traced and not profiling.snapshot()["spans"]


@pytest.mark.parametrize("solver", ["admm_fast", "riccati"])
@pytest.mark.parametrize("plant", ["srb", "fullorder"])
def test_each_period_has_the_ticks_spans(plant, solver):
    """60 eager ticks: each control period's spans are exactly the tick's,
    once ``tick.solve``, ``rbd.*`` in the full-order plant only, all under
    the loop's id and the period's solve tick; the parents as nested."""
    loop = _run(_loop(plant, solver), 60)
    snap = profiling.snapshot()
    want = TICK_SPANS | ({"rbd.crba", "rbd.rnea"} if plant == "fullorder" else set())
    for period in (0, 20, 40):
        seen = {name: int(((c["loop"] == loop.loop_id) & (c["tick"] == period)).sum())
                for name, c in snap["spans"].items()}
        assert {name for name, n in seen.items() if n} == want
        assert seen["tick.solve"] == seen["solve.qp"] == seen["solve.model"] == 1
        assert seen["tick.controller"] == seen["ctrl.pre"] == seen["tick.plant"] == PERIOD
        assert seen["tick.rows"] == 2 * PERIOD
    parents = lambda name: set(snap["spans"][name]["parent"])
    assert parents("tick.controller") == {"tick.solve", None}
    assert parents("ctrl.pre") == parents("ctrl.post") == {"tick.controller"}
    assert parents("solve.model") == parents("solve.qp") == {"tick.controller"}
    if plant == "fullorder":
        assert parents("rbd.crba") == parents("rbd.rnea") == {"tick.plant"}
    assert snap["loops"][loop.loop_id]["device"] == "cpu"
    assert not snap["loops"][loop.loop_id]["nodes"] and loop.traced_graph is None


@pytest.mark.parametrize("plant", ["srb", "fullorder"])
def test_spans_change_no_number(plant):
    """State, carry and metric rows bit for bit with spans on and off."""
    on = _run(_loop(plant, "admm_fast"), 41).result(True)
    profiling.set_enabled(False)
    off = _run(_loop(plant, "admm_fast"), 41).result(True)
    tree.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), on, off)


class _OutsideLayers(TorchDispatchMode):
    """The operations dispatched while no layer span is open."""

    def __init__(self):
        super().__init__()
        self.outside = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(s.name in LAYERS for s in profiling._R.stack):
            self.outside.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("plant,kw", [("srb", {}), ("fullorder", {}),
                                      ("srb", {"estimator": "kf"}),
                                      ("fullorder", {"estimator": "kf", "substeps": 2})])
def test_every_operation_of_a_tick_is_in_a_layer(plant, kw):
    """Every operation a tick dispatches, solve tick or not, runs inside
    ``tick.controller``, ``tick.plant`` or ``tick.rows``: the three layers
    cover the captured tick, so their kernel nodes sum to the graph's."""
    if kw.get("estimator"):
        kw = dict(kw, estimator=kf.KfParams.default(device="cpu"), key=3)
    loop = _loop(plant, "riccati", ticks=22, **kw)
    with _OutsideLayers() as mode:
        _run(loop, 22)
    assert mode.outside == []


def test_profiler_events_carry_the_span_names():
    loop = _loop("fullorder", "riccati", ticks=21)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(loop, 21)
    names = {e.name for e in prof.events()}
    assert TICK_SPANS | {"rbd.crba", "rbd.rnea"} <= names
    # The sync count is a card's: no solve tick was traced for it here.
    assert "solve.traced_ticks" not in profiling.snapshot()["counters"]


@pytest.mark.parametrize("plant", ["srb", "fullorder"])
def test_rollout_asks_for_the_traced_graph_only_under_a_profiler(plant, monkeypatch):
    """A loop its caller steps is built ``traced``; ``rollout()``, which
    runs its loop through in one call, only while a profiler records."""
    env = srb_env if plant == "srb" else fullorder
    seen = []

    class Spy(env.RolloutLoop):
        def _start(self, *args, **kw):
            super()._start(*args, **kw)
            seen.append(self.traced)

    monkeypatch.setattr(env, "RolloutLoop", Spy)
    d = "cpu"
    mpc, robot = default_mpc_params(10, device=d), tree.tile(aliengo(d), 2)
    gait, cmd = tree.tile(Gaits.trotting10(d), 2), tree.tile(Command.trot_forward(0.5, d), 2)
    Spy(robot, mpc, gait, cmd, 2)
    env.rollout(robot, mpc, gait, cmd, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        env.rollout(robot, mpc, gait, cmd, 2)
    assert seen == [True, False, True] and not profiling.recording()


def test_readers_return_none_on_a_cpu_record():
    """Each new reader on the record of a CPU run: 1 warm-up period, 2 in
    the window, 1 traced."""
    _run(_loop("srb", "admm_fast", ticks=80), 80)
    rec, cell, cfg = {"periods": 2}, {"warmup_periods": 1}, {"mpc": {"iterations_between_mpc":
                                                                        PERIOD}}
    assert {name: manifest.reader(name)(rec, cell, cfg) for name in READERS} == dict.fromkeys(
        READERS)


def _card_record():
    """A snapshot as a card's run leaves it: loop 2 (loop 1 an older one),
    one warm-up period, two periods in the window, one traced."""
    def cols(samples):
        loop, tick, host, dev = (np.array(v) for v in zip(*samples))
        return {"loop": loop, "tick": tick, "host_ns": host, "device_ms": dev,
                "start_ns": host * 0, "self_ns": host, "parent": [None] * len(loop)}

    window = lambda ms: [(2, 20, 1e6, ms[0]), (2, 40, 3e6, ms[1]), (2, 0, 9e9, 9.0),
                         (2, 60, 9e9, 9.0), (1, 20, 9e9, 9.0)]
    stamps = np.zeros((80, 6), np.int64)
    # Traced replays at ticks 61 and 62: controller 0-3 (pre 1-2), rows 4-5.
    stamps[61] = [100, 200, 300, 1100, 1200, 1500]
    stamps[62] = [100, 150, 250, 2100, 2200, 2300]
    layout = [("ctrl.pre", "tick.controller", 1, 2), ("tick.controller", None, 0, 3),
              ("tick.rows", None, 4, 5)]
    loop = {"device": "cuda:0", "tick0": 0, "num_ticks": 80, "layout": layout,
            "stamps": stamps, "nodes": {"tick.controller": 300, "tick.rows": 50}}
    return {"spans": {"tick.solve": cols(window((4.0, 6.0))),
                      "ctrl.pre": cols(window((1.0, 2.0))),
                      "ctrl.post": cols(window((0.5, 0.5))),
                      "tick.replay": cols(window((np.nan, np.nan))),
                      "loop.capture": cols([(2, 0, 2e6, np.nan), (2, 0, 1e6, np.nan),
                                            (1, 0, 7e6, np.nan)])},
            "counters": {"solve.syncs": 10, "solve.traced_ticks": 5},
            "loops": {1: dict(loop, device="cuda:0"), 2: loop}}


def test_readers_on_a_card_record(monkeypatch):
    """The readers' arithmetic on a made-up card record: the newest loop,
    the window's periods, per-period sums, stamp differences."""
    monkeypatch.setattr(_spans, "snapshot", _card_record)
    rec, cell, cfg = {"periods": 2}, {"warmup_periods": 1}, {"mpc": {"iterations_between_mpc":
                                                                        PERIOD}}
    got = {name: manifest.reader(name)(rec, cell, cfg) for name in READERS}
    want = {"solve_host_ms": 2.0, "solve_syncs": 2.0, "solve_ms.controller": 2.0,
            "replay_launch_us": 2000.0, "replay_ms.controller": 0.0015, "replay_ms.rows": 0.0002,
            "replay_nodes.controller": 300.0, "replay_nodes.rows": 50.0, "capture_ms": 3.0}
    assert {k: v for k, v in got.items() if v is not None} == pytest.approx(want, rel=1e-12)


class _Marks:
    """A stand-in for a recording tape: the marks the spans leave on it."""

    def __init__(self):
        self.marks = []

    def mark(self, enter, name):
        self.marks.append((enter, name))


def test_taping_spans_mark_their_ends_and_record_nothing():
    """While a tape records, each span marks its entry and exit on it, in
    nesting order, and records no sample."""
    marks = _Marks()
    with profiling.taping(marks):
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    assert marks.marks == [(True, "outer"), (True, "inner"), (False, "inner"),
                           (False, "outer")]
    assert profiling.snapshot()["spans"] == {}


def test_eager_calls_through_outside_a_tape():
    """Outside a tape ``eager(fn, like, ...)`` is ``fn(...)``, whatever
    ``like`` holds; inside a tape's warm-up nothing else may warm up."""
    add = lambda a, b=1: (a + b, (a * b).double())
    x = torch.arange(6.0).reshape(2, 3)
    out = tape_lib.eager(add, (x, x), x, b=2)
    assert torch.equal(out[0], x + 2) and torch.equal(out[1], (2 * x).double())
    t = tape_lib.Tape()
    with t._active("warm"):
        got = tape_lib.eager(add, (x, x.double()), x, b=2)
        with pytest.raises(RuntimeError, match="another tape"):
            with tape_lib.Tape()._active("warm"):
                pass
    assert [g.shape for g in got] == [x.shape, x.shape] and got[1].dtype == torch.float64
    assert not any(bool(g.any()) for g in got) and t._holes == 1 and t.items == []


@pytest.mark.parametrize("plant,solver", [("srb", "riccati"), ("fullorder", "admm_fast")])
def test_a_loop_on_the_cpu_runs_every_solve_tick_eagerly(plant, solver):
    """Taping is for a loop on a card: on the CPU no tick is taped, and the
    solve tick's spans are recorded by the eager tick as before."""
    loop = _loop(plant, solver, ticks=40)
    for _ in range(40):
        loop.step()
    assert loop.tape is None
    names = set(profiling.snapshot()["spans"])
    assert TICK_SPANS <= names


class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: while it
    captures, :func:`_launch` appends each kernel to it; a replay runs them."""

    capturing = None

    def __init__(self, keep_graph=False):
        self.ops = []

    def capture_begin(self, pool=None):
        _FakeGraph.capturing = self

    def capture_end(self):
        _FakeGraph.capturing = None

    def instantiate(self):
        pass

    def replay(self):
        for op in self.ops:
            op()


def _launch(op):
    """A kernel launch: run now, or recorded into the graph being captured."""
    if _FakeGraph.capturing is None:
        op()
    else:
        _FakeGraph.capturing.ops.append(op)


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_a_tape_splits_at_its_spans_and_holes_and_plays_them_in_order(monkeypatch):
    """The tape's logic with a stand-in for stream capture: recording splits
    the tick at each span boundary and eager call, drops empty segments,
    and runs nothing; a play replays the segments in order, calls the
    eager function on what the segment before it left, copies its result
    where the later segments read it, and records the spans as an eager
    tick does."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "capture_nodes", lambda: len(_FakeGraph.capturing.ops))
    x, tmp, y = torch.zeros(2), torch.zeros(2), torch.zeros(2)
    calls = []

    def solve(t):
        calls.append(t.clone())
        return (10.0 * t,)

    def tick():
        with profiling.span("outer"):
            _launch(lambda: x.add_(1.0))
            with profiling.span("inner"):
                _launch(lambda: tmp.copy_(x + 1.0))
            (u,) = tape_lib.eager(solve, (tmp,), tmp)
            _launch(lambda: y.copy_(u + x))

    t = tape_lib.Tape()
    assert t.warm_up(tick) and not calls
    x.zero_(), tmp.zero_(), y.zero_()
    t.record(tick, pool=None)
    assert not calls and not x.any()
    assert [item[0] if item[0] in ("graph", "call") else item for item in t.items] == [
        ("enter", "outer"), "graph", ("enter", "inner"), "graph", ("exit", "inner"), "call",
        "graph", ("exit", "outer")]
    for k in (1, 2):
        t.play()
        assert torch.equal(calls[-1], torch.full((2,), k + 1.0))
        assert torch.equal(y, torch.full((2,), 10.0 * (k + 1) + k))
    cols = profiling.snapshot()["spans"]
    assert len(cols["outer"]["host_ns"]) == 2 and cols["inner"]["parent"] == ["outer"] * 2
