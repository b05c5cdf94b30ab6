"""1-D graph partitioning for Cooperative Minibatching (port of ``repro.core.partition``).

Each vertex (and its incoming edges) is owned by one PE.  The partitioners
are the JAX package's numpy host code, copied, so the owner arrays are
equal element for element; only the finished ``owner`` array moves to the
graph's device.  ``hash`` is the paper's default (cross-edge ratio
``c ≈ (P-1)/P``); ``bfs`` is a greedy multi-source BFS grower standing in
for METIS; ``degree`` balances owned edges, then owned vertices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph import INVALID


@dataclass(frozen=True)
class Partition:
    """Vertex -> PE ownership map."""

    owner: torch.Tensor  # (V,) int32 in [0, P)
    num_parts: int

    def owner_of(self, ids: torch.Tensor) -> torch.Tensor:
        """Owner of every id; INVALID maps to ``num_parts - 1``, as in the
        JAX package (the bucketizer parks padding through its own mask)."""
        invalid = ids == INVALID
        own = self.owner[torch.where(invalid, 0, ids).long()]
        return torch.where(invalid, self.num_parts - 1, own).to(torch.int32)

    def local_rank(self, ids: torch.Tensor) -> torch.Tensor:
        """Stable intra-part index (hash order); used for bucketed A2A."""
        return ids % max(1, self.num_parts)


def _host_csr(graph) -> tuple[np.ndarray, np.ndarray]:
    return graph.indptr.cpu().numpy(), graph.indices.cpu().numpy()


def _partition(owner: np.ndarray, num_parts: int, device) -> Partition:
    return Partition(torch.from_numpy(owner.astype(np.int32)).to(device), num_parts)


def _hash_owner(num_vertices: int, num_parts: int) -> np.ndarray:
    v = np.arange(num_vertices, dtype=np.uint64)
    h = (v * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
    return (h % np.uint64(num_parts)).astype(np.int32)


def hash_partition(num_vertices: int, num_parts: int, device="cpu") -> Partition:
    """Random (hash) partitioning -- the paper's default, c ~ (P-1)/P."""
    return _partition(_hash_owner(num_vertices, num_parts), num_parts, device)


def block_partition(num_vertices: int, num_parts: int, device="cpu") -> Partition:
    """Contiguous blocks (locality-friendly for RMAT-ordered ids)."""
    owner = np.minimum(
        np.arange(num_vertices, dtype=np.int64) * num_parts // num_vertices,
        num_parts - 1,
    ).astype(np.int32)
    return _partition(owner, num_parts, device)


def greedy_bfs_partition(graph, num_parts: int, seed: int = 0) -> Partition:
    """Greedy balanced multi-source BFS growing (METIS proxy, host-side).

    Grows ``num_parts`` regions breadth-first from random seeds, always
    extending the currently-smallest region; unreached vertices fall back
    to hash assignment.
    """
    indptr, indices = _host_csr(graph)
    V = graph.num_vertices
    rng = np.random.default_rng(seed)
    owner = np.full(V, -1, dtype=np.int32)
    target = (V + num_parts - 1) // num_parts
    frontiers: list[list[int]] = [[] for _ in range(num_parts)]
    sizes = np.zeros(num_parts, dtype=np.int64)
    for p, s in enumerate(rng.choice(V, size=num_parts, replace=False)):
        owner[s] = p
        frontiers[p].append(int(s))
        sizes[p] = 1
    active = set(range(num_parts))
    while active:
        p = min(active, key=lambda q: sizes[q])
        if not frontiers[p] or sizes[p] >= target:
            active.discard(p)
            continue
        nxt: list[int] = []
        for v in frontiers[p]:
            for t in indices[indptr[v] : indptr[v + 1]]:
                if owner[t] == -1 and sizes[p] < target:
                    owner[t] = p
                    sizes[p] += 1
                    nxt.append(int(t))
        frontiers[p] = nxt
        if not nxt:
            active.discard(p)
    unassigned = owner == -1
    if unassigned.any():
        owner[unassigned] = _hash_owner(V, num_parts)[unassigned]
    return _partition(owner, num_parts, graph.device)


def degree_balanced_partition(
    graph, num_parts: int, seed: int = 0, tol: float = 0.05
) -> Partition:
    """BFS growth balanced by *owned edges*, then by owned vertices.

    A vertex owns its incoming edges, so per-PE sampling/SpMM work follows
    the owned degree mass.  The grower extends the region with the
    smallest owned degree and caps regions at ``(1 + tol)`` of the mean
    degree load; a final pass sheds the lowest-degree vertices of parts
    whose vertex count exceeds ``(1 + tol)`` of the mean.
    """
    indptr, indices = _host_csr(graph)
    V = graph.num_vertices
    deg = np.diff(indptr).astype(np.int64)
    rng = np.random.default_rng(seed)
    owner = np.full(V, -1, dtype=np.int32)
    deg_target = (deg.sum() / num_parts) * (1.0 + tol)
    frontiers: list[list[int]] = [[] for _ in range(num_parts)]
    deg_load = np.zeros(num_parts, dtype=np.int64)
    for p, s in enumerate(rng.choice(V, size=num_parts, replace=False)):
        owner[s] = p
        frontiers[p].append(int(s))
        deg_load[p] = deg[s]
    active = set(range(num_parts))
    while active:
        p = min(active, key=lambda q: deg_load[q])
        if not frontiers[p] or deg_load[p] >= deg_target:
            active.discard(p)
            continue
        nxt: list[int] = []
        for v in frontiers[p]:
            for t in indices[indptr[v] : indptr[v + 1]]:
                if owner[t] == -1 and deg_load[p] < deg_target:
                    owner[t] = p
                    deg_load[p] += deg[t]
                    nxt.append(int(t))
        frontiers[p] = nxt
        if not nxt:
            active.discard(p)
    unassigned = np.nonzero(owner == -1)[0]
    if len(unassigned):
        # park stragglers on the degree-lightest part round-robin
        order = np.argsort(deg_load)
        owner[unassigned] = np.asarray(order, np.int32)[
            np.arange(len(unassigned)) % num_parts
        ]
    _rebalance_ownership(owner, deg, num_parts, tol)
    return _partition(owner, num_parts, graph.device)


def _rebalance_ownership(
    owner: np.ndarray, deg: np.ndarray, num_parts: int, tol: float
) -> None:
    """In-place vertex-count balancing: shed the cheapest (lowest-degree)
    vertices from over-full parts onto the vertex-lightest part."""
    counts = np.bincount(owner, minlength=num_parts).astype(np.int64)
    cap = int(np.ceil(counts.mean() * (1.0 + tol)))
    for p in range(num_parts):
        if counts[p] <= cap:
            continue
        members = np.nonzero(owner == p)[0]
        shed = members[np.argsort(deg[members], kind="stable")]
        for v in shed[: counts[p] - cap]:
            q = int(np.argmin(counts))
            owner[v] = q
            counts[p] -= 1
            counts[q] += 1


def ownership_balance(graph, part: Partition) -> dict:
    """Balance factors (max load / mean load) for both ownership loads:
    ``vertices`` (seed/ownership) and ``edges`` (sampling + SpMM work)."""
    owner = part.owner.cpu().numpy()
    deg = np.diff(graph.indptr.cpu().numpy()).astype(np.int64)
    counts = np.bincount(owner, minlength=part.num_parts)
    edge_load = np.bincount(owner, weights=deg, minlength=part.num_parts)
    return {
        "vertices": float(counts.max() / max(counts.mean(), 1)),
        "edges": float(edge_load.max() / max(edge_load.mean(), 1.0)),
    }


def cross_edge_ratio(graph, part: Partition) -> float:
    """Fraction ``c`` of edges whose endpoints live on different PEs."""
    indptr, indices = _host_csr(graph)
    owner = part.owner.cpu().numpy()
    dst = np.repeat(np.arange(graph.num_vertices), np.diff(indptr))
    cross = owner[indices] != owner[dst]
    return float(cross.mean()) if len(cross) else 0.0


def make_partition(kind: str, graph, num_parts: int, seed: int = 0) -> Partition:
    """Partition ``graph`` into ``num_parts``; the owner array lives on the
    graph's device."""
    if kind == "hash":
        return hash_partition(graph.num_vertices, num_parts, graph.device)
    if kind == "block":
        return block_partition(graph.num_vertices, num_parts, graph.device)
    if kind in ("bfs", "metis", "greedy"):
        return greedy_bfs_partition(graph, num_parts, seed)
    if kind in ("degree", "degree_balanced"):
        return degree_balanced_partition(graph, num_parts, seed)
    raise ValueError(f"unknown partition kind {kind!r}")
