"""Synthetic bipartite user-item recommendation graph (serving workload).

A numpy copy of ``repro.data.recsys``: the same draws from the same seed,
so both packages build the same graph and features.  ``U`` users and
``I`` items with power-law degrees on both sides -- Pareto user activity
and Zipf item popularity -- so concurrent users' ego-networks overlap in
the hot-item head.

Vertex layout: users occupy ids ``[0, U)``, items ``[U, U + I)``.  The
graph is undirected (edges in both CSR directions).  ``features`` stays a
host numpy array; callers move it to the device explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.device import DeviceLike


def _zipf_probs(n: int, alpha: float) -> np.ndarray:
    """p(rank r) ∝ (r+1)^-alpha, normalized."""
    p = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    return p / p.sum()


def recsys_graph(
    num_users: int = 4096,
    num_items: int = 1024,
    edges_per_user: float = 8.0,
    item_alpha: float = 1.05,
    user_pareto: float = 2.5,
    max_degree: int = 64,
    seed: int = 0,
    device: DeviceLike = None,
) -> Graph:
    """Bipartite user-item interaction graph with power-law degrees."""
    rng = np.random.default_rng(seed)
    U, I = num_users, num_items
    raw = rng.pareto(user_pareto, U) + 1.0
    k_u = np.maximum(1, np.round(raw * (edges_per_user / raw.mean()))).astype(
        np.int64
    )
    src_users = np.repeat(np.arange(U, dtype=np.int64), k_u)
    ranked = rng.permutation(I)
    items = ranked[
        rng.choice(I, size=len(src_users), p=_zipf_probs(I, item_alpha))
    ]
    dst_items = items.astype(np.int64) + U
    key = src_users * (U + I) + dst_items  # dedup repeat interactions
    _, uniq = np.unique(key, return_index=True)
    src_users, dst_items = src_users[uniq], dst_items[uniq]
    src = np.concatenate([src_users, dst_items])
    dst = np.concatenate([dst_items, src_users])
    return Graph.from_edges(
        src, dst, num_vertices=U + I, max_degree=max_degree, seed=seed,
        device=device,
    )


@dataclass
class RecsysDataset:
    """Bipartite graph + host feature rows + the user-id query population."""

    graph: Graph
    num_users: int
    feature_dim: int = 64
    num_classes: int = 16
    seed: int = 0
    features: np.ndarray = field(init=False)
    user_ids: np.ndarray = field(init=False)
    item_ids: np.ndarray = field(init=False)
    train_ids: np.ndarray = field(init=False)

    def __post_init__(self):
        V = self.graph.num_vertices
        if not 0 < self.num_users < V:
            raise ValueError(f"num_users must be in (0, {V}), got {self.num_users}")
        rng = np.random.default_rng(self.seed)
        self.features = rng.standard_normal((V, self.feature_dim)).astype(np.float32)
        self.user_ids = np.arange(self.num_users, dtype=np.int32)
        self.item_ids = np.arange(self.num_users, V, dtype=np.int32)
        self.train_ids = self.user_ids

    @property
    def num_items(self) -> int:
        return self.graph.num_vertices - self.num_users


def make_recsys(
    num_users: int = 4096,
    num_items: int = 1024,
    edges_per_user: float = 8.0,
    feature_dim: int = 64,
    num_classes: int = 16,
    max_degree: int = 64,
    seed: int = 0,
    device: DeviceLike = None,
) -> RecsysDataset:
    """One-call workload constructor (graph on ``device``, features on the host)."""
    g = recsys_graph(
        num_users=num_users, num_items=num_items,
        edges_per_user=edges_per_user, max_degree=max_degree, seed=seed,
        device=device,
    )
    return RecsysDataset(
        g, num_users=num_users, feature_dim=feature_dim,
        num_classes=num_classes, seed=seed,
    )
