"""The guard that the measured process runs without JAX: no module whose
top-level name (the part before the first dot, compared whole) is one of
``FORBIDDEN``.  ``repro_torch`` passes; ``repro`` is the JAX package."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The loaded module names (``sys.modules`` by default) that are JAX's or
    the JAX package's, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
