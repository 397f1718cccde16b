"""Data-parallel placement of a scenario batch (port of ``parallel/mesh.py``).

JAX lays a 1-D ``('data',)`` mesh over every chip of the job, places each
shard of a batch on its chip and lowers cross-scenario reductions to
collectives.  PyTorch runs one process per card: a :class:`DataMesh` is
the process group, this process's rank and the group's size, and the
rank's device, on the one ``"data"`` axis.  A rank holds the contiguous
rows ``[rank * B / size, (rank + 1) * B / size)`` of a global batch of B
scenarios, and the reductions (:func:`global_sum`, :func:`global_mean`,
:func:`global_max`) are explicit collectives over the group.

The sweep is embarrassingly parallel: a condensed 120-variable QP fits one
scenario's share of a card, so ranks exchange only reduced metrics, a few
scalars per chunk, never state.  With one process (no process group) every
placement is the identity and every reduction is local.

Each collective records span ``mesh.reduce`` (:mod:`..utils.profiling`:
the host's time to pack, reduce and unpack; under NCCL the reduction is
queued on the card's stream, so the span holds its launch, not its wait)
and adds to counters ``mesh.collectives`` (one a call) and
``mesh.reduce_bytes`` (the float64 buffer's bytes).  A local reduction
records nothing.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from pympc_quadruped_tpu_torch.tree import flatten, tree_map
from pympc_quadruped_tpu_torch.utils import profiling


@dataclass(frozen=True)
class DataMesh:
    """One rank's view of the 1-D ``"data"`` mesh: the process group
    (``None`` for a single process), this rank, the number of ranks and the
    rank's device."""

    group: object | None
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        """The group's collective backend (``"nccl"`` or ``"gloo"``), or
        ``None`` for a single process."""
        return None if self.group is None else dist.get_backend(self.group)


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; a bare ``"cuda"`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(device="cuda") -> DataMesh:
    """The mesh over every rank of the default process group (a single
    rank when none is initialized), this rank's batch on ``device``."""
    dev = _device(device)
    if dist.is_available() and dist.is_initialized():
        return DataMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev)
    return DataMesh(None, 0, 1, dev)


@dataclass(frozen=True)
class BatchSharding:
    """The batch axis split over the mesh's ranks (JAX's
    ``NamedSharding(mesh, P("data"))``): called on a global-batch tensor it
    returns this rank's rows on the rank's device."""

    mesh: DataMesh

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` scenarios."""
        size = self.mesh.size
        if batch % size:
            raise ValueError(f"batch {batch} not divisible by {size} hosts")
        n = batch // size
        return slice(self.mesh.rank * n, (self.mesh.rank + 1) * n)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh.size == 1:
            return x.to(self.mesh.device)
        return x[self.rows(x.shape[0])].to(self.mesh.device)


def batch_sharding(mesh: DataMesh) -> BatchSharding:
    return BatchSharding(mesh)


def shard_batch(tree, mesh: DataMesh):
    """Place a scenario-batched tree with its batch axis split over the
    ranks: every rank passes the same global tree and keeps its rows."""
    return tree_map(batch_sharding(mesh), tree)


def shard_global_batch(tree, mesh: DataMesh):
    """Multi-process :func:`shard_batch`.  In JAX only this form is valid
    across hosts (a process can populate only its own devices' shards); with
    one process per card the two are the same operation: each rank keeps
    the rows it owns of the global tree that every rank passes."""
    return shard_batch(tree, mesh)


def replicate(tree, mesh: DataMesh):
    """The same tree on every rank's device."""
    return tree_map(lambda x: x.to(mesh.device), tree)


def _all_reduce(tree, mesh: DataMesh, op):
    """``tree``'s leaves reduced over the ranks with ``op``, in one
    collective of a float64 buffer (exact for float32, integer and bool
    leaves).  Under NCCL the buffer stays on the card; under gloo, whose
    collectives on CUDA tensors are partial, it goes through the host.
    Each leaf comes back with its dtype and device; every rank gets the
    same values."""
    if mesh.group is None:
        return tree
    with profiling.span("mesh.reduce"):
        leaves = list(flatten(tree).values())
        where = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        buf = torch.cat([t.detach().reshape(-1).to(where, torch.float64) for t in leaves])
        dist.all_reduce(buf, op=op, group=mesh.group)
        parts = iter(torch.split(buf, [t.numel() for t in leaves]))
        out = tree_map(lambda t: next(parts).reshape(t.shape).to(t.device, t.dtype), tree)
    profiling.count("mesh.collectives")
    profiling.count("mesh.reduce_bytes", buf.numel() * buf.element_size())
    return out


def global_sum(tree, mesh: DataMesh):
    """Each leaf summed elementwise over the ranks (a ``psum``)."""
    return _all_reduce(tree, mesh, dist.ReduceOp.SUM)


def global_max(tree, mesh: DataMesh):
    """Each leaf's largest element over every rank's shard: a 0-d tensor of
    the leaf's dtype."""
    return _all_reduce(tree_map(lambda t: t.amax(), tree), mesh, dist.ReduceOp.MAX)


def global_mean(tree, mesh: DataMesh):
    """Each leaf's mean over every element of every rank's shard (equal
    shards, as :func:`shard_batch` makes them): float64 partial sums,
    reduced over the ranks and divided once, so a sharded run's mean is the
    unsharded run's whenever its per-row values are.  A 0-d float32 tensor
    per leaf."""
    sums = global_sum(tree_map(lambda t: t.double().sum(), tree), mesh)
    return tree_map(lambda s, t: (s / (t.numel() * mesh.size)).float(), sums, tree)
