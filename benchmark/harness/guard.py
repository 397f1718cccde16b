"""Which modules of JAX or of the JAX package a process holds, compared by
whole top-level name (``pympc_quadruped_tpu_torch`` is not
``pympc_quadruped_tpu``)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pympc_quadruped_tpu")


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})
