"""The import guard: no run may load JAX or the JAX package."""
from __future__ import annotations

import sys

# Top-level module names that a run may not load, compared whole: the
# port, statmc_tpu_torch, passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "statmc_tpu")


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
