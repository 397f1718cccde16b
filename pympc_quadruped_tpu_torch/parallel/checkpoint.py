"""Checkpoint and resume for long scenario sweeps (port of
``parallel/checkpoint.py``, which wraps orbax's ``CheckpointManager``).

A sweep's whole state (env states, controller carries with their warm
starts, filter states, the absolute tick) must survive preemption.
:class:`SweepCheckpointer` persists any tree of the port's
(:mod:`..tree`) under ``directory``:

    ckpt = SweepCheckpointer(dir, keep=3)
    step, state = ckpt.restore_or(init_state)   # resume if a step exists
    while ...:
        state = run_chunk(state)
        ckpt.save(step, state)                  # host copy now, write in the background
    ckpt.close()

Layout: one directory per step, ``<directory>/<step>/``, holding one file
per rank, ``rank<r>-of-<n>.pt``, with that rank's leaves (its rows of a
sharded leaf, its copy of a replicated one) as a flat ``{path: tensor}``
dict, and a ``commit`` marker.  ``torch.load`` reads it with
``weights_only=True``: no pickled object is ever loaded.  Each file is
written under a temporary name and renamed, and whichever rank finds every
rank's file in place after its own rename writes the marker (also by
rename), so a step counts only once it is whole: a kill during a save
leaves the previous step the latest.  Every save and :meth:`wait` passes a
barrier under a process group, after which rank 0 prunes the directory to
the ``keep`` newest committed steps (all of them while fewer are
committed) and removes steps left unfinished: a save prunes before it
writes, and :meth:`close` prunes after the last write, so the directory
ends with the ``min(keep, saves)`` newest steps, as orbax's
``max_to_keep`` leaves it.  A step directory is the checkpointer's only
when it holds nothing but these files (and their temporary names): any
other directory under ``directory``, another tool's checkpoint among them,
is neither read nor removed.

Spans and counters (:mod:`..utils.profiling`): ``ckpt.save`` around
:meth:`SweepCheckpointer.save`, with children ``ckpt.copy`` (the copy to
the host), ``ckpt.join`` (the wait for this rank's previous write) and
``ckpt.prune`` (both barriers and the removal), which :meth:`wait` also
records, without a parent; counters ``ckpt.saves``, ``ckpt.pruned`` (step
directories removed, on rank 0) and ``ckpt.write_ns`` (the time of each
write to disk: the background writer records no span, since the span stack
is the process's, not a thread's).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import torch
import torch.distributed as dist

from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.utils import profiling


#: The names a step directory of this module holds.
_OWN_FILE = re.compile(r"(rank\d+-of-\d+\.pt|commit)(\.tmp\d+)?")


def _own_steps(directory: str) -> list[int]:
    """The step directories under ``directory`` that hold nothing but a
    :class:`SweepCheckpointer`'s files, oldest first."""
    return sorted(int(p) for p in os.listdir(directory)
                  if p.isdigit() and os.path.isdir(os.path.join(directory, p))
                  and all(_OWN_FILE.fullmatch(f) for f in os.listdir(os.path.join(directory, p))))


def _committed_steps(directory: str) -> list[int]:
    return [s for s in _own_steps(directory)
            if os.path.exists(os.path.join(directory, str(s), "commit"))]


def read_step(directory: str, step: int | None = None) -> tuple[int, list[dict]]:
    """``(step, files)``: every rank's flat ``{path: tensor}`` dict of a
    committed step (the newest by default), in rank order, on the CPU.  For
    comparing two runs' checkpoints; a sweep resumes by
    :meth:`SweepCheckpointer.restore_or`."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = _committed_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no committed step in {directory}")
        step = steps[-1]
    step_dir = os.path.join(directory, str(step))
    with open(os.path.join(step_dir, "commit")) as f:
        size = json.load(f)["world_size"]
    return step, [torch.load(os.path.join(step_dir, f"rank{r}-of-{size}.pt"), map_location="cpu",
                             weights_only=True) for r in range(size)]


class SweepCheckpointer:
    def __init__(self, directory: str, keep: int | None = 3, async_save: bool = True):
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be None (keep every step) or at least 1, not {keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep, self.async_save = keep, async_save
        on = dist.is_available() and dist.is_initialized()
        self._group = dist.group.WORLD if on else None
        self.rank = dist.get_rank() if on else 0
        self.size = dist.get_world_size() if on else 1
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- layout -------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _rank_file(self, step: int, rank: int) -> str:
        return os.path.join(self._step_dir(step), f"rank{rank}-of-{self.size}.pt")

    def _steps(self) -> list[int]:
        return _own_steps(self.directory)

    def _committed(self) -> list[int]:
        return _committed_steps(self.directory)

    @property
    def latest_step(self) -> int | None:
        """The newest committed step, or ``None``."""
        steps = self._committed()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any) -> None:
        """Persist ``state`` at ``step``: this rank's leaves are copied to
        the host before ``save`` returns, so the caller may overwrite them
        at once (a replayed CUDA graph writes its static buffers in place),
        and written to disk in the background unless ``async_save`` is
        false."""
        with profiling.span("ckpt.save"):
            with profiling.span("ckpt.copy"):
                flat = {k: v.detach().to("cpu", copy=True)
                        for k, v in tree.flatten(state).items()}
            if step in self._committed():
                raise ValueError(f"step {step} already exists in {self.directory}")
            if os.path.isdir(self._step_dir(step)) and step not in self._steps():
                raise ValueError(f"{self._step_dir(step)} holds files that are not a "
                                 "SweepCheckpointer's")
            self._join()
            self._sync_and_prune()
            profiling.count("ckpt.saves")
            if self.async_save:
                self._writer = threading.Thread(target=self._write_guarded,
                                                args=(step, flat), daemon=False)
                self._writer.start()
            else:
                self._write(step, flat)

    def _write_guarded(self, step, flat) -> None:
        try:
            self._write(step, flat)
        except BaseException as e:  # re-raised by the next save, wait or close
            self._error = e

    def _write(self, step: int, flat: dict) -> None:
        t0 = time.perf_counter_ns()
        os.makedirs(self._step_dir(step), exist_ok=True)
        final = self._rank_file(step, self.rank)
        tmp = f"{final}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        if all(os.path.exists(self._rank_file(step, r)) for r in range(self.size)):
            marker = os.path.join(self._step_dir(step), "commit")
            tmp = f"{marker}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"step": step, "world_size": self.size}, f)
            os.replace(tmp, marker)
        profiling.count("ckpt.write_ns", time.perf_counter_ns() - t0)

    def _join(self) -> None:
        """Wait for this rank's write in flight and raise its error."""
        with profiling.span("ckpt.join"):
            if self._writer is not None:
                self._writer.join()
                self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _sync_and_prune(self) -> None:
        """Barrier, then rank 0 keeps the ``keep`` newest committed steps
        (every one while fewer are committed) and removes every other step
        directory of its own (none is being written: each rank has joined
        its writer), then a barrier again."""
        with profiling.span("ckpt.prune"):
            if self._group is not None:
                dist.barrier(group=self._group)
            if self.rank == 0:
                committed = self._committed()
                kept = set(committed if self.keep is None
                           else committed[max(0, len(committed) - self.keep):])
                gone = [s for s in self._steps() if s not in kept]
                for s in gone:
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
                profiling.count("ckpt.pruned", len(gone))
            if self._group is not None:
                dist.barrier(group=self._group)

    # -- restore ------------------------------------------------------------

    def restore_or(self, init_state: Any):
        """``(0, init_state)`` when no step is committed, else ``(step,
        restored)``: the latest step's leaves rebuilt into ``init_state``'s
        structure, each with the dtype, shape and device of ``init_state``'s
        leaf (orbax's restore onto an abstract target).  A checkpoint saved
        by another number of ranks raises: it is not resharded."""
        step = self.latest_step
        if step is None:
            return 0, init_state
        with open(os.path.join(self._step_dir(step), "commit")) as f:
            saved_size = json.load(f)["world_size"]
        if saved_size != self.size:
            raise ValueError(
                f"checkpoint step {step} in {self.directory} was saved by {saved_size} "
                f"ranks; this run has {self.size} (restoring onto another number of ranks "
                "is not supported)")
        flat = torch.load(self._rank_file(step, self.rank), map_location="cpu",
                          weights_only=True)
        want = tree.flatten(init_state)
        if set(flat) != set(want):
            raise ValueError(
                f"checkpoint step {step} does not match the state's structure: missing "
                f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}")

        def put(path, leaf):
            saved = flat["/".join(path)]
            if saved.shape != leaf.shape:
                raise ValueError(f"checkpoint leaf {'/'.join(path)} has shape "
                                 f"{tuple(saved.shape)}, the state {tuple(leaf.shape)}")
            return saved.to(device=leaf.device, dtype=leaf.dtype)

        return step, tree.tree_map_with_path(put, init_state)

    def wait(self) -> None:
        """Block until every rank's pending save is committed (a barrier
        under a process group), then prune."""
        self._join()
        self._sync_and_prune()

    def close(self) -> None:
        self.wait()
