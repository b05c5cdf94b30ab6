"""Synthetic power-law graph datasets (RMAT) with features and labels.

A numpy copy of ``repro.data.synthetic``: the same draws from the same
seed, so both packages build the same graph, features, labels and splits
bit for bit.  The graph lands on ``device``; features, labels and the
splits stay host numpy arrays, which callers move to the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.device import DeviceLike


def rmat_edges(
    scale: int,
    edge_factor: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Classic RMAT generator: 2**scale vertices, edge_factor*V edges."""
    rng = np.random.default_rng(seed)
    V = 1 << scale
    E = edge_factor * V
    src = np.zeros(E, dtype=np.int64)
    dst = np.zeros(E, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(E)
        go_src = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        go_dst = (r >= a) & (r < a + b) | (r >= a + b + c)
        src |= go_src.astype(np.int64) << bit
        dst |= go_dst.astype(np.int64) << bit
    keep = src != dst  # drop self loops
    return src[keep], dst[keep]


def rmat_graph(
    scale: int = 12,
    edge_factor: int = 8,
    max_degree: int = 64,
    undirected: bool = True,
    num_edge_types: int = 1,
    seed: int = 0,
    device: DeviceLike = None,
) -> Graph:
    """Degree-capped RMAT graph on ``device`` (CUDA unless ``"cpu"``)."""
    src, dst = rmat_edges(scale, edge_factor, seed=seed)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = src * (1 << scale) + dst  # dedup parallel edges
    _, uniq_idx = np.unique(key, return_index=True)
    src, dst = src[uniq_idx], dst[uniq_idx]
    et = None
    if num_edge_types > 1:
        rng = np.random.default_rng(seed + 1)
        et = rng.integers(0, num_edge_types, size=len(src)).astype(np.int32)
    return Graph.from_edges(
        src, dst, num_vertices=1 << scale, edge_types=et, max_degree=max_degree,
        num_edge_types=num_edge_types, seed=seed, device=device,
    )


@dataclass
class SyntheticGraphDataset:
    """Graph + node features + labels + train/val/test split.

    Features are standard normal draws per vertex; labels come from a
    hidden teacher over own + 1-hop-mean features, so a GNN can fit them.
    """

    graph: Graph
    feature_dim: int = 64
    num_classes: int = 16
    seed: int = 0
    features: np.ndarray = field(init=False)
    labels: np.ndarray = field(init=False)
    train_ids: np.ndarray = field(init=False)
    val_ids: np.ndarray = field(init=False)
    test_ids: np.ndarray = field(init=False)

    def __post_init__(self):
        V = self.graph.num_vertices
        rng = np.random.default_rng(self.seed)
        feats = rng.standard_normal((V, self.feature_dim)).astype(np.float32)
        self.features = feats
        W = rng.standard_normal((self.feature_dim, self.num_classes)).astype(
            np.float32
        )
        indptr = self.graph.indptr.cpu().numpy()
        indices = self.graph.indices.cpu().numpy()
        deg = np.maximum(np.diff(indptr), 1)
        agg = np.zeros_like(feats)
        np.add.at(agg, np.repeat(np.arange(V), np.diff(indptr)), feats[indices])
        agg /= deg[:, None]
        logits = (feats + agg) @ W
        self.labels = np.argmax(logits, axis=1).astype(np.int32)
        perm = rng.permutation(V)
        n_tr, n_val = int(0.6 * V), int(0.2 * V)
        self.train_ids = np.sort(perm[:n_tr]).astype(np.int32)
        self.val_ids = np.sort(perm[n_tr : n_tr + n_val]).astype(np.int32)
        self.test_ids = np.sort(perm[n_tr + n_val :]).astype(np.int32)

    def seed_batch(self, step: int, batch_size: int, split: str = "train") -> np.ndarray:
        """Deterministic epoch-shuffled seed-vertex batch (host-side)."""
        ids = {"train": self.train_ids, "val": self.val_ids, "test": self.test_ids}[
            split
        ]
        n = len(ids)
        per_epoch = max(1, n // batch_size)
        epoch, it = divmod(step, per_epoch)
        order = np.random.default_rng(self.seed + 17 * epoch).permutation(n)
        sel = order[it * batch_size : (it + 1) * batch_size]
        return ids[sel]
