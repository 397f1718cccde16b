"""One run of a sweep cell: the port's chunked, checkpointed scenario sweep
over several ranks, one card each.

The parent (``run.py``, through :func:`run`) builds the port's kernel
libraries once, then starts one process a rank with the port's own
launcher (``parallel/launch.launcher_env`` and ``run_ranks``; NCCL, one
card a rank, ``OMP_NUM_THREADS=1``, ``NCCL_SHM_DISABLE=1``):

    python -m benchmark.harness.sweep <job.json>

Each rank joins the group (``launch.init_distributed``), draws the global
pool of robots from the seed and keeps its rows ``[n r, n (r + 1))``, and
runs the production sweep's calls, as ``examples/sweep.py``'s
``run_chunk`` makes them, chunk after chunk: a ``srb_env.RolloutLoop``
built from the previous chunk's state and full carry (``init_state``,
``carry_in``, ``tick0``), stepped one 20-tick control period at a time
(the same ``step()`` that ``rollout`` calls a tick at a time, so that the
periods can be marked), its ``result``, the summary all-reduced over the
ranks (``mesh.global_mean`` / ``global_max`` / ``global_sum``) and
``SweepCheckpointer.save`` (async, under ``TMPDIR``).  The harness waits
for the card at a chunk's end before the reductions, and reads their
result to the host, so that the reductions' and the save's host times
hold neither the chunk's last replays nor each other; the production
loop waits for the same replays inside the save's device-to-host copy.

Set-up ends after one whole warm-up chunk with its save.  The window runs
whole chunks until ``seconds`` have passed on rank 0's host clock (rank 0
broadcasts the decision after each chunk), then a barrier.  A CUDA event
marks each period's start, and a period runs to the next one's start, so
the last period of a chunk holds the chunk's reductions, its save and the
next chunk's build and capture.  With ``trace`` all ranks run one more
chunk and the start of another, and rank 0 profiles the periods around
that chunk boundary.

The check (each rank, after the window, the memory peak read):

- ``qp_data``, ``cost_excess``, ``state``, ``excluded_share``:
  :mod:`.check` on the rank's sampled robots and periods (one of them a
  chunk's first period), against the plain reference;
- ``handover``: the bytes in which the state, full carry and tick that
  enter a chunk differ from those the previous chunk returned, at one
  boundary drawn from the seed;
- ``reduction``: the largest relative gap between a summary value the
  rank received and a float64 recomputation from every rank's rows,
  gathered after the window, over the window's chunks;
- ``checkpoint``: the bytes in which the newest committed step read back
  (``checkpoint.read_step``) differs from the state the harness handed to
  the last ``save`` (inf where that step is not the newest committed);
  ``kept_steps_off``: how far the committed steps are from the
  configuration's ``checkpoint_keep`` (or the saves made, where fewer).

Rank 0 writes the record of the run (every rank's numbers, and the worst
of each) for the parent.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T_IMPORT = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check, closed_loop, program  # noqa: E402
from benchmark.traffic import generator  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
#: Seconds the parent waits for the ranks of one call.
RANK_TIMEOUT = 1100
#: The check's numbers beyond :data:`check.NUMBERS`, each with its limit.
SWEEP_NUMBERS = ("handover", "reduction", "checkpoint", "kept_steps_off")
#: The summary each chunk all-reduces, in the order the harness reads it.
SUMMARY = ("mean_vel_err", "max_vel_err", "mean_height", "survival_frac", "divergence_events")


# ---------------------------------------------------------------------------
# The parent: build once, start the ranks, read rank 0's records
# ---------------------------------------------------------------------------

def build_libraries() -> float:
    """Build the port's kernel libraries in a process of its own, which
    loads ``_build.py`` alone (no torch, no card), before any rank starts;
    the ranks then find them built.  Returns the seconds it took."""
    code = ("import importlib.util, sys; s = importlib.util.spec_from_file_location("
            "'_build', sys.argv[1]); m = importlib.util.module_from_spec(s); "
            "sys.modules['_build'] = m; s.loader.exec_module(m); m.load_all()")
    t = time.time()
    subprocess.run([sys.executable, "-c", code,
                    str(ROOT / "pympc_quadruped_tpu_torch" / "_build.py")], check=True)
    return time.time() - t


def run(cell: dict, cfg: dict, mix: dict, runs: list, seconds: float, trace: bool, device,
        t_start: float, batch: int | None = None, ranks: int | None = None,
        chunk_ticks: int | None = None, timeout: float = RANK_TIMEOUT) -> list:
    """Rank 0's record of each of ``runs`` (dicts with ``seed`` and, for
    calibration and tests, ``fault``, a name of ``calibrate.FAULTS``
    planted in every rank, ``control``, the control's numbers too, and
    ``tf32``, the port run with TF32 products allowed),
    all made by one set of rank processes.  ``batch``, ``ranks`` and
    ``chunk_ticks`` replace the configuration's in the CPU tests."""
    from pympc_quadruped_tpu_torch.parallel import launch

    ranks = ranks or cfg["ranks"]
    build_s = build_libraries() if torch.device(device).type == "cuda" else 0.0
    out = Path(tempfile.mkdtemp(prefix="sweep-"))
    try:
        job = dict(cell=cell, cfg=cfg, mix=mix, runs=runs, seconds=seconds, trace=trace,
                   device=str(device), t_start=t_start, batch=batch, chunk_ticks=chunk_ticks,
                   out=str(out), build_s=build_s)
        path = out / "job.json"
        path.write_text(json.dumps(job))
        port = launch.free_port()
        jobs = [([sys.executable, "-m", "benchmark.harness.sweep", str(path)],
                 dict(launch.launcher_env(port, r, ranks), NCCL_SHM_DISABLE="1"))
                for r in range(ranks)]
        launch.run_ranks(jobs, timeout=timeout)
        return [json.loads((out / f"run{i}.json").read_text()) for i in range(len(runs))]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every number the cell
    limits: each at or under its limit; one not finite fails."""
    names = [k for k in check.NUMBERS + SWEEP_NUMBERS if k in limits]
    report = {k: {"value": numbers[k], "limit": limits[k]} for k in names}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in report.values())
    return ok, report


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

def _bytes_apart(a: dict, b: dict) -> float:
    """Bytes in which the leaves of two flat dicts differ (inf where their
    keys, shapes or dtypes differ): a device tensor, or a float."""
    if a.keys() != b.keys():
        return float("inf")
    total = None
    for k, x in a.items():
        y = b[k]
        if x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        bx = x.detach().contiguous().reshape(-1).view(torch.uint8)
        by = y.detach().to(x.device).contiguous().reshape(-1).view(torch.uint8)
        n = (bx != by).sum()
        total = n if total is None else total + n
    return total if total is not None else 0.0


def _flat(env, carry, tick) -> dict:
    """A chunk's state, full carry and tick as one flat dict."""
    return {**{f"env/{k}": v for k, v in program.flat(env).items()},
            **{f"carry/{k}": v for k, v in program.flat(carry).items()}, "tick": tick}


class _Never:
    """A reservoir that samples nothing (warm-up and traced periods)."""

    k = 0

    def offer(self):
        return None


class RankSweep:
    """One rank's sweep: its rows of the robots, its checkpointer, the
    state that enters the next chunk, and what the window records."""

    def __init__(self, job: dict, seed: int, mesh, ckpt_dir: str):
        from pympc_quadruped_tpu_torch.env import srb_env
        from pympc_quadruped_tpu_torch.parallel.checkpoint import SweepCheckpointer

        cell, cfg, mix = job["cell"], job["cfg"], job["mix"]
        self.cell, self.cfg, self.mix, self.mesh = cell, cfg, mix, mesh
        self.dev = mesh.device
        self.cuda = self.dev.type == "cuda"
        B = job["batch"] or cfg["batch"]
        if B % mesh.size:
            raise ValueError(f"batch {B} does not divide over {mesh.size} ranks")
        n = B // mesh.size
        self.T = job["chunk_ticks"] or cfg["chunk_ticks"]
        self.P = cfg["mpc"]["iterations_between_mpc"]
        if self.T % self.P:
            raise ValueError(f"a chunk of {self.T} ticks is not whole control periods")
        # Every rank draws the global pool from the seed and keeps its rows.
        lo = mesh.rank * n
        self.draws = {k: v[lo:lo + n] for k, v in generator.draw(mix, B, seed).items()}
        self.pick = generator.rng_for(seed, 1 + mesh.rank)
        self.rows_np = np.sort(self.pick.choice(n, size=min(cell["check"]["rows"], n),
                                                replace=False))
        self.rows = torch.as_tensor(self.rows_np, device=self.dev)
        self.robot, self.mpc, self.gait, self.cmd, self.solver_cfg = program.objects(
            cfg, self.draws, self.dev)
        f32 = lambda v: program._t(v, self.dev)
        s0 = srb_env.default_init_state(self.robot)
        s0 = dataclasses.replace(s0, pos=s0.pos + f32(self.draws["dpos"]),
                                 vel=s0.vel + f32(self.draws["dvel"]))
        self.start = {k: v.index_select(0, self.rows) for k, v in program.flat(s0).items()}
        self.state = {"env": s0, "carry": srb_env.init_full_carry(self.robot, self.mpc, s0),
                      "tick": torch.tensor(0, dtype=torch.int32, device=self.dev)}
        self.ckpt = SweepCheckpointer(ckpt_dir, keep=cfg["checkpoint_keep"])
        self.step = 0
        self.probe = program.SolveProbe(cfg["solver"], self.rows)
        self.marks = closed_loop.Marks(self.cuda)
        self.loop = None

    def build(self):
        """The next chunk's loop, as ``srb_env.rollout`` builds it from the
        state and full carry the previous chunk returned."""
        from pympc_quadruped_tpu_torch.env import srb_env
        from pympc_quadruped_tpu_torch.utils import profiling

        self.loop = None  # the previous chunk's graph and buffers go first
        self.loop = srb_env.RolloutLoop(
            self.robot, self.mpc, self.gait, self.cmd, self.T, init_state=self.state["env"],
            solver=self.cfg["solver"], auto_reset=self.mix["auto_reset"],
            carry_in=self.state["carry"], tick0=int(self.state["tick"]),
            solver_cfg=self.solver_cfg, traced=profiling.recording())

    def periods(self, n: int, ev: list, reservoir=None, slots=None) -> None:
        closed_loop.periods(self.loop, n, self.P, self.rows, self.probe, self.marks,
                            reservoir or _Never(), slots, ev)

    def reduce(self, env, metrics) -> dict:
        """The chunk's summary over every rank, as the production sweep
        reduces it (``examples/sweep.py``'s ``run_chunk``, with
        ``rollout_sweep``'s survival)."""
        from pympc_quadruped_tpu_torch.parallel import mesh as mesh_lib, sweep

        tail = metrics["vel_err"][-self.T // 4:]
        means = mesh_lib.global_mean({
            "mean_vel_err": tail, "mean_height": metrics["height"][-1],
            "survival_frac": sweep._alive(env, metrics, self.T).float()}, self.mesh)
        return {"mean_vel_err": means["mean_vel_err"],
                "max_vel_err": mesh_lib.global_max(tail, self.mesh),
                "mean_height": means["mean_height"], "survival_frac": means["survival_frac"],
                "divergence_events": mesh_lib.global_sum(
                    metrics["diverged"].sum(dtype=torch.int32), self.mesh)}

    def finish(self) -> tuple:
        """End the chunk: its result, the reductions read to the host, and
        the save of the state that enters the next chunk.  Returns (the
        chunk's metric rows, its final state, the summary received,
        reductions' ms, save's ms)."""
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        (env, carry), metrics = self.loop.result(return_full_carry=True)
        summary = self.reduce(env, metrics)
        got = torch.stack([summary[k].double() for k in SUMMARY]).cpu()
        collective_ms = (time.perf_counter() - t) * 1e3
        self.state = {"env": env, "carry": carry, "tick": self.state["tick"] + self.T}
        self.step += 1
        t = time.perf_counter()
        self.ckpt.save(self.step, self.state)
        save_ms = (time.perf_counter() - t) * 1e3
        return metrics, env, got, collective_ms, save_ms

    def barrier(self) -> None:
        if self.mesh.group is not None:
            torch.distributed.barrier(group=self.mesh.group)

    def rank0_says(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.mesh.group is None:
            return flag
        where = self.dev if self.mesh.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([int(flag)], dtype=torch.int32, device=where)
        torch.distributed.broadcast(t, src=0, group=self.mesh.group)
        return bool(t.item())


def _robot_stats(metrics: dict, env_pos: torch.Tensor, T: int) -> np.ndarray:
    """Per robot, in float64 on the host: the sum and the max of the last
    quarter's velocity error, the last height, the diverged ticks, and
    whether it survived (height in (0.1, 1.0) and upright above 0.6 over
    the last quarter, ``parallel/sweep``'s rule): (5, n)."""
    tail = metrics["vel_err"][-T // 4:].double().cpu()
    upright = metrics["upright"][-T // 4:].double().cpu()
    z = env_pos[:, 2].double().cpu()
    alive = (z > 0.1) & (z < 1.0) & (upright.amin(0) > 0.6)
    return torch.stack([tail.sum(0), tail.amax(0), metrics["height"][-1].double().cpu(),
                        metrics["diverged"].double().sum(0).cpu(), alive.double()]).numpy()


def reduction_gap(got: np.ndarray, stats: list, T: int) -> float:
    """The largest relative gap between the summary values one rank
    received for a chunk (in :data:`SUMMARY` order) and their float64
    recomputation from every rank's per-robot ``stats``."""
    s = np.concatenate(stats, axis=1)
    n = s.shape[1]
    q = len(range(T)[-T // 4:])
    want = np.array([s[0].sum() / (q * n), s[1].max(), s[2].sum() / n,
                     s[4].sum() / n, s[3].sum()])
    gap = np.abs(np.asarray(got, np.float64) - want) / np.maximum(np.abs(want), 1e-30)
    gap = np.where(np.isfinite(gap), gap, np.inf)
    return float(gap.max())


def _traced(rs: RankSweep, k: int) -> dict:
    """One more chunk and the start of another on every rank; rank 0
    profiles its last ``k // 2`` periods, the chunk boundary and the next
    chunk's first ``k - k // 2``."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import trace as tr

    before, after = k // 2, k - k // 2
    per_chunk = rs.T // rs.P
    prof = None
    if rs.mesh.rank == 0:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if rs.cuda else [])
        prof = profile(activities=acts)
    ev = []
    rs.build()
    rs.periods(per_chunk - before, ev)
    if prof is not None:
        prof.start()
    a = rs.marks.mark()
    rs.periods(before, ev)
    rs.finish()
    rs.build()
    rs.periods(after, ev)
    b = rs.marks.mark()
    if rs.cuda:
        torch.cuda.synchronize()
    if prof is None:
        return {}
    prof.stop()
    dev = tr.device_intervals(prof)
    merged = tr.union(dev)
    return dict(window_s=rs.marks.ms(a, b) * 1e-3,
                busy_s=sum(e - s for s, e in merged) * 1e-6,
                kernels=tr.kernel_table(dev),
                idle_gaps=tr.idle_gaps(merged, tr.host_intervals(prof)),
                traced_periods=k)


def _committed(directory: str) -> int:
    """Step directories holding a commit marker: the harness's own count."""
    return sum(1 for p in os.listdir(directory)
               if p.isdigit() and os.path.exists(os.path.join(directory, p, "commit")))


def run_rank(job: dict, spec: dict, mesh, ckpt_dir: str) -> dict:
    """One run on this rank: set-up, the window, the traced periods, the
    check.  Returns this rank's part of the record."""
    from pympc_quadruped_tpu_torch import tree
    from pympc_quadruped_tpu_torch.env import graph_loop
    from pympc_quadruped_tpu_torch.ops.qp import admm_cuda
    from pympc_quadruped_tpu_torch.parallel.checkpoint import read_step

    from benchmark.harness import guard

    cell, cfg, mix = job["cell"], job["cfg"], job["mix"]
    parts = {"start_and_imports": T_IMPORT - job["t_start"], "join": job["joined"] - T_IMPORT}
    t = time.time()
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rs = RankSweep(job, spec["seed"], mesh, ckpt_dir)
    parts["draw"] = time.time() - t
    launches0, captures0 = dict(admm_cuda.LAUNCHES), graph_loop.CAPTURES
    try:
        t = time.time()
        for _ in range(cell["warmup_chunks"]):
            rs.build()
            rs.periods(rs.T // rs.P, [])
            rs.finish()
        rs.barrier()
        parts["warm_up"] = time.time() - t
        setup_s = time.time() - job["t_start"]

        # The window: whole chunks until rank 0's clock passes `seconds`.
        first = closed_loop.Reservoir(1, rs.pick)
        rest = closed_loop.Reservoir(cell["check"]["periods"] - 1, rs.pick)
        boundary = closed_loop.Reservoir(1, rs.pick)
        slots_first, slots_rest = [None] * first.k, [None] * rest.k
        ev, kept, build_ms, collective_ms, save_ms = [], [], [], [], []
        handover = None
        t0 = time.perf_counter()
        while True:
            tb = time.perf_counter()
            rs.build()
            build_ms.append((time.perf_counter() - tb) * 1e3)
            if boundary.offer() is not None:
                buf, handed = rs.loop.buf, rs.state
                handover = _bytes_apart(_flat(buf.state, buf.carry, buf.tick),
                                        _flat(handed["env"], handed["carry"], handed["tick"]))
            rs.periods(1, ev, first, slots_first)
            rs.periods(rs.T // rs.P - 1, ev, rest, slots_rest)
            metrics, env, got, c_ms, s_ms = rs.finish()
            closed_loop.diverged_flags(slots_first + slots_rest, rs.rows)
            kept.append((metrics, env.pos, got))
            collective_ms.append(c_ms)
            save_ms.append(s_ms)
            if rs.rank0_says(time.perf_counter() - t0 >= job["seconds"]):
                break
        rs.barrier()
        end = rs.marks.mark()
        if rs.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        starts = [a for a, _, _ in ev] + [end]
        period_ms = [rs.marks.ms(a, b) for a, b in zip(starts, starts[1:])]
        rec = dict(setup_s=setup_s, wall_s=wall, chunks=len(kept),
                   periods_per_chunk=rs.T // rs.P,
                   ticks=len(kept) * rs.T * rs.mesh.size * len(rs.draws["vx"]),
                   period_ms=period_ms, chunk_build_ms=build_ms, collective_ms=collective_ms,
                   checkpoint_save_ms=save_ms)
        if job["trace"] and cell["trace_periods"]:
            rec.update(_traced(rs, cell["trace_periods"]))
        rec["launches"] = {k: v - launches0[k] for k, v in admm_cuda.LAUNCHES.items()}
        rec["captures"] = graph_loop.CAPTURES - captures0
        rec["solve_calls"] = rs.probe.calls
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if rs.cuda else 0
        rec["kind"] = torch.cuda.get_device_name() if rs.cuda else "cpu"
    finally:
        rs.probe.close()
    rs.loop = None
    t_check = time.perf_counter()

    # The checkpoint: every save committed, the newest read back.
    rs.ckpt.close()
    kept_steps = _committed(ckpt_dir)
    kept_steps_off = abs(kept_steps - min(cfg["checkpoint_keep"], rs.step))
    try:
        step, files = read_step(ckpt_dir)
    except FileNotFoundError:
        step, files = None, None
    if step != rs.step:
        checkpoint = float("inf")
    else:
        want = {k: v.cpu() for k, v in tree.flatten(rs.state).items()}
        checkpoint = float(_bytes_apart(files[mesh.rank], want))
    rs.state = None

    # The reductions, against every rank's rows gathered after the window.
    stats = [_robot_stats(m, pos, rs.T) for m, pos, _ in kept]
    got = [g.numpy() for _, _, g in kept]
    del kept
    every = [None] * mesh.size
    if mesh.group is not None:
        torch.distributed.all_gather_object(every, stats, group=mesh.group)
    else:
        every = [stats]
    reduction = max((reduction_gap(got[c], [r[c] for r in every], rs.T)
                     for c in range(len(got))), default=0.0)
    del every, stats
    if rs.cuda:
        torch.cuda.empty_cache()

    # The closed loop's answers on the sampled robots and periods.
    slots = [s for s in slots_first + slots_rest if s is not None]
    limits = cell["check"]["limits"]
    robot_rows = program.robot_rows(cfg, rs.draws)
    per = check.judge(cfg, mix, cfg["solver"], robot_rows, rs.draws, rs.rows_np, rs.start,
                      slots, rs.dev)
    numbers, attempted, failed = check.summary(per, limits)
    numbers.update(handover=float("inf") if handover is None else float(handover),
                   reduction=reduction, checkpoint=checkpoint,
                   kept_steps_off=float(kept_steps_off))
    failed += sum(not numbers[k] <= limits[k] for k in SWEEP_NUMBERS)
    rec.update(numbers=numbers, attempted=attempted + len(SWEEP_NUMBERS), failed=failed,
               checked_ticks=[s["t"] for s in slots], kept_steps=kept_steps,
               saves=rs.step)
    if spec.get("control"):
        cper = check.judge(cfg, mix, cfg["solver"], robot_rows, rs.draws, rs.rows_np,
                           rs.start, slots, rs.dev, control=check.TF32)
        rec["control"] = check.summary(cper, limits)[0]
    rec["check_s"] = time.perf_counter() - t_check
    rec["setup_parts"] = parts
    rec["forbidden"] = guard.forbidden_loaded()
    return rec


def _by_place(period_ms: list, per_chunk: int) -> dict:
    """Median period by its place in the chunk: the first (the new loop's
    first replays), the last (the chunk's reductions, save and the next
    build and capture), the others."""
    place = lambda i: ("first" if i % per_chunk == 0 else
                       "last" if i % per_chunk == per_chunk - 1 else "other")
    out = {}
    for i, p in enumerate(period_ms):
        out.setdefault(place(i), []).append(p)
    return {k: statistics.median(v) for k, v in out.items()}


def combine(recs: list, limits: dict) -> dict:
    """Rank 0's record of the run: its own timings and trace, the pooled
    periods, the fullest card's memory peak, every rank's numbers and, for
    each number, the worst over the ranks."""
    out = dict(recs[0])
    out["period_ms"] = [p for r in recs for p in r["period_ms"]]
    out["period_quartiles_ms"] = [statistics.quantiles(r["period_ms"], n=4)
                                  if len(r["period_ms"]) > 1 else r["period_ms"] for r in recs]
    out["period_median_ms_by_place"] = [_by_place(r["period_ms"], r["periods_per_chunk"])
                                        for r in recs]
    out["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in recs)
    out["per_rank"] = [{k: r[k] for k in ("numbers", "chunk_build_ms", "collective_ms",
                                          "checkpoint_save_ms", "attempted", "failed",
                                          "check_s", "kept_steps", "saves", "setup_parts")}
                       for r in recs]
    worst = {}
    for r in recs:
        for k, v in r["numbers"].items():
            if k == "diag":
                d = worst.setdefault("diag", {})
                for dk, dv in v.items():
                    d[dk] = max(d.get(dk, dv), dv)
            else:
                worst[k] = max(worst.get(k, v), v)
    out["numbers"] = worst
    if all("control" in r for r in recs):
        out["control"] = {k: max(r["control"][k] for r in recs)
                          for k in recs[0]["control"] if k != "diag"}
    out["attempted"] = sum(r["attempted"] for r in recs)
    out["failed"] = sum(r["failed"] for r in recs)
    out["forbidden"] = sorted({m for r in recs for m in r["forbidden"]})
    out["correct"], out["report"] = verdict(worst, limits)
    out["correct"] = out["correct"] and out["failed"] == 0
    return out


def main(argv=None) -> int:
    job = json.loads(Path((argv or sys.argv[1:])[0]).read_text())
    import torch.distributed as dist

    import pympc_quadruped_tpu_torch  # noqa: F401  (pins TF32 off for the port)
    from pympc_quadruped_tpu_torch.parallel import launch

    from benchmark import calibrate

    backend = launch.init_distributed(device=job["device"])
    mesh = launch.global_data_mesh(job["device"])
    job["joined"] = time.time()
    for i, spec in enumerate(job["runs"]):
        undo = calibrate.plant(job["cfg"], spec["fault"]) if spec.get("fault") else None
        torch.backends.cuda.matmul.allow_tf32 = bool(spec.get("tf32"))
        try:
            rec = run_rank(job, spec, mesh, os.path.join(job["out"], f"ckpt{i}"))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            if undo is not None:
                undo()
        recs = [None] * mesh.size
        if backend is not None:
            dist.all_gather_object(recs, rec)
        else:
            recs = [rec]
        if mesh.rank == 0:
            out = combine(recs, job["cell"]["check"]["limits"])
            out.update(seed=spec["seed"], fault=spec.get("fault"), build_s=job["build_s"])
            tmp = Path(job["out"]) / f"run{i}.json.tmp"
            tmp.write_text(json.dumps(out))
            tmp.replace(Path(job["out"]) / f"run{i}.json")
    # A rank that raised has left the loop above without this barrier: the
    # others fail at their next collective, and the parent reports it.
    if backend is not None:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
