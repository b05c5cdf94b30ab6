"""Full-neighborhood "sampler" (no sampling; k >= max degree) -- port of
``repro.core.samplers.full``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.graph import Graph
from repro_torch.core.rng import DependentRNG
from repro_torch.core.samplers.base import LayerSample


@dataclass(frozen=True)
class FullSampler:
    name: str = "full"
    backend: str = "reference"  # neighbor_table backend ("reference"|"fused")

    def row_width(self, graph: Graph) -> int:
        return graph.max_degree

    def sample_layer(
        self, graph: Graph, seeds: torch.Tensor, rng: DependentRNG, layer: int
    ) -> LayerSample:
        nbr, mask = graph.neighbor_table(seeds, backend=self.backend)
        etypes = (
            graph.neighbor_edge_types(seeds) if graph.edge_types is not None else None
        )
        return LayerSample(seeds=seeds, nbr=nbr, mask=mask, etypes=etypes)
