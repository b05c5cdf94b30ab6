"""Neighbor Sampling (GraphSAGE; Hamilton et al., 2017) -- port of
``repro.core.samplers.neighbor``.

For seed ``s`` with degree ``d_s``: keep the whole neighborhood if
``d_s <= k``; otherwise pick ``k`` neighbors without replacement, the ``k``
smallest per-edge keys ``r_ts`` (``DependentRNG.edge_uniform``, so smoothed
dependent minibatching applies to them as well).

The JAX package takes them with ``jax.lax.top_k(-keys, k)``, which puts the
lower slot first among equal keys (the masked slots' ``inf`` keys
included); ``torch.topk`` promises no order among ties, so this module
sorts the keys stably and takes the first ``k``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.graph import INVALID, Graph
from repro_torch.core.rng import DependentRNG
from repro_torch.core.samplers.base import LayerSample


@dataclass(frozen=True)
class NeighborSampler:
    fanout: int = 10
    name: str = "ns"
    backend: str = "reference"  # neighbor_table backend ("reference"|"fused")

    def row_width(self, graph: Graph) -> int:
        return min(self.fanout, graph.max_degree)

    def sample_layer(
        self, graph: Graph, seeds: torch.Tensor, rng: DependentRNG, layer: int
    ) -> LayerSample:
        nbr_full, mask_full = graph.neighbor_table(seeds, backend=self.backend)
        seeds_b = seeds[:, None].expand(nbr_full.shape)
        keys = rng.edge_uniform(nbr_full, seeds_b, salt=layer)
        nbr, mask, idx = bottom_k(nbr_full, mask_full, keys, self.row_width(graph))
        etypes = None
        if graph.edge_types is not None:
            etypes = torch.gather(graph.neighbor_edge_types(seeds), 1, idx)
        return LayerSample(seeds=seeds, nbr=nbr, mask=mask, etypes=etypes)


def bottom_k(nbr: torch.Tensor, mask: torch.Tensor, keys: torch.Tensor, k: int):
    """The ``k`` smallest keys of each row, ties to the lower slot; masked
    slots key ``inf``.  Returns ``(sel, sel_mask, idx)``."""
    keys = torch.where(mask, keys, torch.inf)
    top, idx = torch.sort(keys, dim=1, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    sel_mask = torch.isfinite(top)
    sel = torch.where(sel_mask, torch.gather(nbr, 1, idx), INVALID)
    return sel, sel_mask, idx
