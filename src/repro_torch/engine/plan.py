"""The common ``Plan`` protocol both minibatch flavors satisfy (port of
``repro.engine.plan``).

A *plan* is the static-shape output of sampling: L bipartite layer
blocks, the input frontier whose features must load, and the seed
frontier whose labels are supervised.  ``Minibatch`` (independent, §2.3)
and ``CoopMinibatch`` (cooperative, §3.1) both satisfy it, so training
loops consume either without mode branches; the engine owns the only
mode dispatch (model apply).
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class Plan(Protocol):
    """Uniform surface of a sampled L-layer minibatch plan."""

    layers: Sequence          # per-layer bipartite blocks (mode-specific)
    input_ids: torch.Tensor   # deepest frontier S^L -- rows to fetch
    seed_ids: torch.Tensor    # seed frontier S^0 -- rows to supervise

    def gather_inputs(self, store) -> torch.Tensor:
        """Input-layer embeddings from a ``FeatureStore``-like object
        (anything with ``gather(ids) -> (..., d)`` zeroing INVALID rows)."""
        ...

    def stats(self) -> dict:
        """Vertex/edge/communication counts: ``S{l}``, ``E{l}``,
        ``comm{l+1}``, ``inputs``; cooperative plans add ``tilde{l+1}``.
        Stacked plans report per-PE maxima."""
        ...
