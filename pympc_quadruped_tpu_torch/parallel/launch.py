"""Multi-process launch helpers (port of ``parallel/launch.py``).

Every process runs the same sweep program over its rows of the global
scenario batch, one process per card, and the sweep's metric reductions
are collectives over ``torch.distributed``.  JAX's host maps onto a rank
here: ``per_host_batch`` is the scenario count of one rank.

Launch with torchrun, which sets the variables :func:`init_distributed`
reads:

    torchrun --nproc-per-node 4 -m pympc_quadruped_tpu_torch.examples.sweep ...

or by hand, one process each with ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set; :func:`launcher_env` makes
that environment for ranks on this host and :func:`run_ranks` starts them.
The join itself records span ``launch.join`` (:mod:`..utils.profiling`).
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess

import torch
import torch.distributed as dist

from pympc_quadruped_tpu_torch.parallel.mesh import DataMesh, data_mesh
from pympc_quadruped_tpu_torch.utils import profiling


#: The process group's timeout for every collective.
TIMEOUT = datetime.timedelta(seconds=300)


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> str | None:
    """Join the process group (a no-op for a single process); returns the
    backend, ``"nccl"`` or ``"gloo"``, or ``None`` when nothing was started.

    The arguments fall back on torch's launcher variables in place of JAX's
    ``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``:
    ``coordinator`` on ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` on
    ``WORLD_SIZE`` and ``process_id`` on ``RANK``.  As in JAX, one process
    with no coordinator starts nothing, while a coordinator with one process
    starts a group of one.

    On a ``device`` of type ``"cuda"`` the rank binds card ``LOCAL_RANK``
    (or ``process_id``) modulo the cards present, before anything is
    allocated; the port's constructors then allocate there.  The group runs
    NCCL when each process of the host has a card of its own
    (``LOCAL_WORLD_SIZE``, or ``num_processes``, at most the card count),
    and gloo otherwise: on the CPU, and for several ranks on one card, which
    NCCL refuses.  Under gloo the tensors stay on the card; only the reduced
    metrics pass through the host (:mod:`.mesh`).  Every collective times
    out after :data:`TIMEOUT`, so a lost rank fails the others instead of
    hanging them."""
    if coordinator is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    if num_processes in (None, 1) and coordinator is None:
        return None  # single process
    if coordinator is None:
        raise ValueError(f"{num_processes} processes but no coordinator: pass coordinator= "
                         "or set MASTER_ADDR and MASTER_PORT")
    num_processes = num_processes or 1
    process_id = process_id or 0
    backend, card = "gloo", None
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device 'cuda' asked for, but no CUDA card is visible")
        local_rank = _int_env("LOCAL_RANK")
        local_size = _int_env("LOCAL_WORLD_SIZE") or num_processes
        card = torch.device("cuda", (process_id if local_rank is None else local_rank) % cards)
        torch.cuda.set_device(card)
        if local_size <= cards:
            backend = "nccl"
    with profiling.span("launch.join"):
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id, timeout=TIMEOUT,
            **({"device_id": card} if backend == "nccl" else {}))
    return backend


def global_data_mesh(device="cuda") -> DataMesh:
    """1-D ``"data"`` mesh over every rank of the job (one card each):
    contiguous batch shards on consecutive ranks, this rank's on
    ``device``."""
    return data_mesh(device)


def per_host_batch(global_batch: int) -> int:
    """Scenario count this rank materializes of a sharded global batch."""
    n_proc = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if global_batch % n_proc:
        raise ValueError(f"global batch {global_batch} not divisible by {n_proc} hosts")
    return global_batch // n_proc


# ---------------------------------------------------------------------------
# Ranks on this host, started by hand (torchrun's job in one host)
# ---------------------------------------------------------------------------

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A free TCP port on localhost for a coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher_env(port: int | None = None, rank: int = 0, nprocs: int = 1) -> dict:
    """The environment of a child process that runs this package: this
    process's, without inherited launcher variables, with the package's
    root on ``PYTHONPATH`` and ``OMP_NUM_THREADS=1`` (torchrun's setting
    for several ranks a host: each rank's intra-op threads would otherwise
    claim every core).  With a ``port``, the child is rank ``rank`` of
    ``nprocs`` on this host: torch's launcher variables on a coordinator at
    ``localhost:port``, and collectives over the loopback interface."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                                "LOCAL_WORLD_SIZE"))}
    env.update(PYTHONPATH=_PACKAGE_ROOT, OMP_NUM_THREADS="1")
    if port is not None:
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                   RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    return env


def run_ranks(jobs, timeout: float = 600) -> list[str]:
    """Start every ``(argv, env)`` of ``jobs`` at once, wait for all and
    return their outputs (standard output and error together).  A process
    that exits non-zero, or outlives ``timeout`` seconds, raises
    ``RuntimeError`` with the tail of its output; every process still
    running is killed first."""
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, errors="replace")
             for argv, env in jobs]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"{' '.join(map(str, e.cmd))} outlived {timeout} s") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (argv, _), p, out in zip(jobs, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(map(str, argv))} exited {p.returncode}:\n"
                               f"{out[-4000:]}")
    return outs
