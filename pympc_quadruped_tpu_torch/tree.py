"""Maps over the port's parameter/state dataclasses (the pytree counterpart).

A "tree" here is a tensor, a tuple of trees, or a dataclass whose fields
are tensors, nested dataclasses or tuples, dicts of tensors, or static
Python values (ints/bools such as ``MpcParams.horizon``), which
pass through unchanged.
"""
from __future__ import annotations

import dataclasses

import torch


def tree_map_with_path(fn, obj, *rest, path: tuple = ()):
    """Apply ``fn(path, leaf, *matching leaves of rest)`` to every tensor
    leaf of ``obj`` (``rest`` must share its structure); ``path`` is the
    tuple of field names, tuple indices and dict keys (as strings) from the
    root to the leaf."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map_with_path(fn, getattr(obj, f.name),
                                       *(getattr(r, f.name) for r in rest),
                                       path=path + (f.name,))
            for f in dataclasses.fields(obj)
        })
    if isinstance(obj, tuple):
        return tuple(tree_map_with_path(fn, o, *(r[i] for r in rest), path=path + (str(i),))
                     for i, o in enumerate(obj))
    if isinstance(obj, dict):
        return {k: tree_map_with_path(fn, o, *(r[k] for r in rest), path=path + (str(k),))
                for k, o in obj.items()}
    if isinstance(obj, torch.Tensor):
        return fn(path, obj, *rest)
    return obj


def tree_map(fn, obj, *rest):
    """Apply ``fn`` to every tensor leaf of ``obj`` (and the matching leaves
    of ``rest``, which must share its structure)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), obj, *rest)


def to(obj, device):
    """The same tree with every tensor on ``device``."""
    return tree_map(lambda t: t.to(device), obj)


def tile(obj, batch: int):
    """Broadcast every leaf to a leading scenario axis of size ``batch``."""
    return tree_map(
        lambda t: t.expand((batch,) + tuple(t.shape)).contiguous(), obj
    )


def flatten(obj) -> dict:
    """Every tensor leaf of ``obj`` keyed by its path, joined with ``/``."""
    leaves = {}

    def visit(path, leaf):
        leaves["/".join(path)] = leaf
        return leaf

    tree_map_with_path(visit, obj)
    return leaves
