"""The guard against the JAX package: a run fails when its process has
loaded JAX, jaxlib, flax or the JAX package ``repro``. Names are compared
whole, by their top-level part, since the port's own name, ``repro_torch``,
begins with ``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (by default, every
    module this process has loaded)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
