"""RandomWalk sampling (PinSAGE; Ying et al., 2018) -- port of
``repro.core.samplers.random_walk``.

``a`` walks of length ``o`` with restart probability ``p`` from every
seed; the ``k`` most-visited vertices become the seed's sampled
neighborhood.  Every step draws from ``hash_u32`` under a sub-seed
``fold``-ed from the step's RNG state, so the walks are integer state and
equal the JAX package's bit for bit.

Ties are the rule here, not the exception: the JAX package counts each
row's visits with ``jnp.unique(size=o*a, fill_value=INVALID,
return_counts=True)`` (sorted ids, INVALID last with its count zeroed)
and takes ``jax.lax.top_k(counts, k)``, which puts the lower position
first among equal counts.  This module counts the runs of a row sort and
takes the first ``k`` of a stable sort of the negated counts: the same
order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.graph import INVALID, Graph
from repro_torch.core.rng import DependentRNG, _f, hash_u32, uniform_from_u32
from repro_torch.core.samplers.base import LayerSample


@dataclass(frozen=True)
class RandomWalkSampler:
    fanout: int = 10
    walk_length: int = 3
    restart_prob: float = 0.5
    num_walks: int = 16
    name: str = "rw"
    # Accepted for factory uniformity; a walk has no neighbor-table
    # expansion to fuse, so both values run the same code.
    backend: str = "reference"

    def row_width(self, graph: Graph) -> int:
        return self.fanout

    def sample_layer(
        self, graph: Graph, seeds: torch.Tensor, rng: DependentRNG, layer: int
    ) -> LayerSample:
        visited = walk(graph, seeds, rng.fold(salt=1000 + layer), self.walk_length,
                       self.restart_prob, self.num_walks)
        nbr, mask = top_visited(visited, self.fanout)
        valid_seed = (seeds != INVALID)[:, None]
        return LayerSample(seeds=seeds, nbr=torch.where(valid_seed, nbr, INVALID),
                           mask=mask & valid_seed)


def walk(graph: Graph, seeds: torch.Tensor, z: int, o: int, p: float, a: int) -> torch.Tensor:
    """``(n, o*a)`` int32 vertices visited by ``a`` walks of ``o`` steps from
    each seed (walk-major per step), the seed itself replaced by INVALID."""
    n = seeds.shape[0]
    dev = seeds.device
    indptr, indices = graph.indptr, graph.indices
    walk_ids = torch.arange(n * a, dtype=torch.int32, device=dev).reshape(n, a)
    seeds_b = seeds[:, None].expand(n, a)
    last_edge = max(graph.num_edges - 1, 0)

    def random_neighbor(cur, salt):
        """One uniform in-neighbor of each walker; INVALID if none/invalid."""
        safe = torch.where(cur == INVALID, 0, cur).long()
        offs = indptr[safe]
        deg = indptr[safe + 1] - offs
        u = uniform_from_u32(hash_u32(walk_ids, z, salt) ^ hash_u32(cur, z + 7, salt))
        pick = offs + torch.minimum((u * deg).to(torch.int32), (deg - 1).clamp(min=0))
        nxt = indices[pick.clamp(0, last_edge).long()]
        return torch.where((deg > 0) & (cur != INVALID), nxt, INVALID)

    cur = random_neighbor(seeds_b, 0)
    cur = torch.where(cur == INVALID, seeds_b, cur)
    visits = [cur]
    for salt in range(1, o):
        restart = uniform_from_u32(hash_u32(walk_ids, z + 13, salt)) < _f(p)
        nxt = random_neighbor(torch.where(restart, seeds_b, cur), salt)
        # dead-end walkers restart from the seed next step
        cur = torch.where(nxt == INVALID, seeds_b, nxt)
        visits.append(cur)
    visited = torch.stack(visits, dim=1).reshape(n, o * a)
    # never count the seed itself as its own neighbor
    return torch.where(visited == seeds[:, None], INVALID, visited)


def top_visited(visited: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's ``k`` most frequent ids (INVALID never counts), ties to the
    smaller id; ``(nbr, mask)`` with ``mask = count > 0``."""
    n, m = visited.shape
    ids, _ = torch.sort(visited, dim=1)
    starts = torch.ones_like(ids, dtype=torch.bool)
    starts[:, 1:] = ids[:, 1:] != ids[:, :-1]
    run = torch.cumsum(starts, dim=1) - 1                     # run index per entry
    uniq = torch.full_like(ids, INVALID).scatter_(1, run, ids)
    counts = torch.zeros((n, m), dtype=torch.int64, device=ids.device)
    counts.scatter_add_(1, run, (ids != INVALID).to(torch.int64))
    neg, idx = torch.sort(-counts, dim=1, stable=True)
    top = -neg[:, :k]
    sel = torch.gather(uniq, 1, idx[:, :k])
    mask = top > 0
    return torch.where(mask, sel, INVALID), mask
