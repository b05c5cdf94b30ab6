"""LABOR sampling (Balin & Catalyurek, 2023) -- port of ``repro.core.samplers.labor``.

LABOR-0: every vertex ``t`` rolls ONE uniform ``r_t`` shared by all seeds
in the batch; edge ``(t -> s)`` is kept iff ``r_t <= k / d_s``.

LABOR-* (importance variant): keep iff ``r_t <= min(1, c_s * pi_t)`` with
per-seed normalizers ``c_s`` solving ``sum_t min(1, c_s pi_t) = k`` by a
40-step bisection, and ``pi_t`` proportional to sqrt(out-degree(t)).

The row sums inside LABOR-*'s bisection are taken in sequential order,
element after element; ``tests/test_torch_plan.py`` pins the resulting
plans against the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.graph import INVALID, Graph
from repro_torch.core.rng import DependentRNG
from repro_torch.core.samplers.base import LayerSample


def importance_probs(graph: Graph) -> torch.Tensor:
    """pi_t proxy: sqrt of out-degree, normalized to mean 1."""
    out_deg = torch.zeros(graph.num_vertices, dtype=torch.float32, device=graph.device)
    out_deg.index_add_(
        0, graph.indices.long(),
        torch.ones(graph.num_edges, dtype=torch.float32, device=graph.device),
    )
    pi = torch.sqrt(torch.clamp(out_deg, min=1.0).double()).float()
    return pi / pi.mean()


@dataclass(frozen=True)
class LaborSampler:
    fanout: int = 10
    importance: bool = False    # False -> LABOR-0, True -> LABOR-*
    backend: str = "reference"  # neighbor_table backend ("reference"|"fused")

    @property
    def name(self) -> str:
        return "labor*" if self.importance else "labor0"

    def row_width(self, graph: Graph) -> int:
        return graph.max_degree

    def sample_layer(
        self, graph: Graph, seeds: torch.Tensor, rng: DependentRNG, layer: int
    ) -> LayerSample:
        nbr, mask = graph.neighbor_table(seeds, backend=self.backend)
        deg = mask.sum(dim=1).to(torch.float32)
        r = rng.vertex_uniform(nbr, salt=layer)  # shared r_t across the batch
        if not self.importance:
            thresh = torch.clamp(self.fanout / torch.clamp(deg, min=1.0), max=1.0)
            accept = r <= thresh[:, None]
        else:
            pi = importance_probs(graph)
            pi_t = pi[torch.where(nbr == INVALID, 0, nbr).long()]
            c_s = _solve_cs(pi_t, mask, float(self.fanout))
            accept = r <= torch.clamp(c_s[:, None] * pi_t, max=1.0)
        accept = accept & mask
        sampled = torch.where(accept, nbr, INVALID)
        etypes = (
            graph.neighbor_edge_types(seeds) if graph.edge_types is not None else None
        )
        return LayerSample(seeds=seeds, nbr=sampled, mask=accept, etypes=etypes)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis, added left to right."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _solve_cs(pi_t: torch.Tensor, mask: torch.Tensor, k: float) -> torch.Tensor:
    """Per-row bisection for c_s:  sum_t min(1, c_s*pi_t) = k."""
    pi = torch.where(mask, pi_t, 0.0)
    deg = mask.sum(dim=1).to(torch.float32)
    lo = torch.zeros_like(deg)
    hi = torch.full_like(deg, 1e6)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        expected = _row_sum(torch.clamp(mid[:, None] * pi, max=1.0))
        too_small = expected < k
        lo, hi = torch.where(too_small, mid, lo), torch.where(too_small, hi, mid)
    c = 0.5 * (lo + hi)
    # if d_s <= k the whole neighborhood is kept (threshold 1 for all t)
    return torch.where(deg <= k, torch.full_like(c, 1e6), c)
