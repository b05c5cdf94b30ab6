"""Sampler interface (port of ``repro.core.samplers.base``).

A sampler maps a padded seed frontier ``S^l`` to the sampled in-edges of
that layer: a fixed-width table ``nbr[(n, row_width)]`` of source ids
(INVALID padded) and its validity mask.  All randomness comes from a
:class:`repro_torch.core.rng.DependentRNG` (hashed per vertex), so a
vertex's sample does not depend on which batch it is in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

import torch

from repro_torch.core.graph import Graph
from repro_torch.core.rng import DependentRNG


@dataclass(frozen=True)
class LayerSample:
    """Sampled in-edges of one layer: dst row i is seeds[i]."""

    seeds: torch.Tensor  # (n,) int32, INVALID padded, sorted
    nbr: torch.Tensor    # (n, row_width) int32 source ids, INVALID padded
    mask: torch.Tensor   # (n, row_width) bool
    etypes: Optional[torch.Tensor] = None  # (n, row_width) int32 relation ids


class Sampler(Protocol):
    name: str

    def row_width(self, graph: Graph) -> int:
        ...

    def sample_layer(
        self, graph: Graph, seeds: torch.Tensor, rng: DependentRNG, layer: int
    ) -> LayerSample:
        ...


def make_sampler(name: str, fanout: int = 10, **kw) -> "Sampler":
    """Factory: 'labor0' | 'labor*' (ported); 'ns' | 'rw' | 'full' not yet."""
    from repro_torch.core.samplers.labor import LaborSampler

    name = name.lower()
    if name in ("labor0", "labor-0"):
        return LaborSampler(fanout=fanout, importance=False, **kw)
    if name in ("labor*", "labor-*", "labor_star"):
        return LaborSampler(fanout=fanout, importance=True, **kw)
    if name in ("ns", "neighbor", "rw", "randomwalk", "random_walk", "full"):
        raise NotImplementedError(
            f"sampler {name!r} is not ported to repro_torch yet "
            "(ROADMAP.md queue A, item A9)"
        )
    raise ValueError(f"unknown sampler {name!r}")
