"""Every input of a run, made on the device from ``--seed``.

A degree-capped RMAT graph (its edges drawn, made undirected, deduplicated
and capped with draws of this file's own), vertex features, labels, the
training ids and the model's initial weights.  Each kind of input has a
``torch.Generator`` of its own, seeded from the run's seed and the kind,
so any one of them can be made again on its own (the reference makes the
features and the weights again once the program has been freed).  The
same seed on the same device gives the same inputs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

# one stream of draws per kind of input
GRAPH, FEATURES, LABELS, TRAIN_IDS, WEIGHTS, CAP = range(6)


def generator(seed: int, kind: int, device) -> torch.Generator:
    """The generator of one kind of input for ``seed`` (any integer)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + kind * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


@dataclass
class GraphArrays:
    """An in-CSR graph as int32 device arrays: row ``s`` holds the sources of
    the edges into ``s``, ascending; ``etypes`` aligns with ``indices``."""

    indptr: torch.Tensor
    indices: torch.Tensor
    etypes: Optional[torch.Tensor]
    num_vertices: int
    max_degree: int
    num_edge_types: int


def rmat_graph(seed: int, scale: int, edge_factor: int, max_degree: int,
               num_edge_types: int, abc, device) -> GraphArrays:
    """``edge_factor * 2**scale`` RMAT edges with the quadrant probabilities
    ``abc`` (``d`` the rest), self loops dropped, made undirected and
    deduplicated; every in-degree above ``max_degree`` cut to a uniform draw
    of ``max_degree`` of its edges; edge types uniform over
    ``num_edge_types``."""
    g = generator(seed, GRAPH, device)
    V, E = 1 << scale, edge_factor << scale
    a, b, c = abc
    src = torch.zeros(E, dtype=torch.int64, device=device)
    dst = torch.zeros(E, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(E, generator=g, device=device)
        src |= (r >= a + b).long() << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).long() << bit
        del r
    keep = src != dst
    src, dst = src[keep], dst[keep]
    del keep
    key = torch.cat([dst * V + src, src * V + dst])  # both directions
    del src, dst
    key = torch.unique(key)                            # sorted by (dst, src)
    dst = key // V
    # cap: a random priority per edge, the lowest max_degree of a row kept
    prio = torch.randint(0, 1 << 31, key.shape, generator=generator(seed, CAP, device),
                         device=device)
    order = torch.argsort((dst << 31) | prio)
    del prio
    counts = torch.bincount(dst, minlength=V)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=device) - start[dst[order]]
    del order, start
    key = key[rank < max_degree]                       # still sorted by (dst, src)
    del rank, dst
    dst, src = key // V, key % V
    del key
    counts = torch.bincount(dst, minlength=V)
    indptr = torch.zeros(V + 1, dtype=torch.int32, device=device)
    indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    etypes = None
    if num_edge_types > 1:
        etypes = torch.randint(0, num_edge_types, src.shape, generator=g, device=device,
                               dtype=torch.int32)
    return GraphArrays(indptr, src.to(torch.int32), etypes, V,
                       int(counts.max()) if V else 0, num_edge_types)


def degree_stats(graph: GraphArrays, cap: int) -> dict:
    """The in-degrees the graph realizes: their mean over all vertices, the
    share of vertices with none, and the share at the cap."""
    deg = (graph.indptr[1:] - graph.indptr[:-1]).double()
    return {"mean_in_degree": float(deg.mean()),
            "isolated_share": float((deg == 0).double().mean()),
            "capped_share": float((deg >= cap).double().mean())}


def graph_of(seed: int, config: dict, device) -> GraphArrays:
    """The graph of a configuration (its ``graph`` group) for ``seed``."""
    g = config["graph"]
    return rmat_graph(seed, g["scale"], g["edge_factor"], g["max_degree"], g["num_edge_types"],
                      g["rmat_abc"], device)


def features(seed: int, num_vertices: int, dim: int, device) -> torch.Tensor:
    """Standard normal float32 features ``(V, dim)``."""
    return torch.randn((num_vertices, dim), generator=generator(seed, FEATURES, device),
                       device=device)


def labels(seed: int, num_vertices: int, num_classes: int, device) -> torch.Tensor:
    """Uniform int32 class labels ``(V,)``."""
    return torch.randint(0, num_classes, (num_vertices,), dtype=torch.int32, device=device,
                         generator=generator(seed, LABELS, device))


def train_ids(seed: int, graph: GraphArrays, fraction: float, device) -> torch.Tensor:
    """A uniform draw of ``round(fraction * V)`` of the vertices that have an
    in-edge (a labeled vertex of the datasets stood for has citations or
    relations; RMAT leaves many vertices isolated), ascending (int32)."""
    deg = graph.indptr[1:] - graph.indptr[:-1]
    cand = torch.nonzero(deg > 0).squeeze(1)
    n = min(cand.numel(), max(1, round(fraction * graph.num_vertices)))
    perm = torch.randperm(cand.numel(), generator=generator(seed, TRAIN_IDS, device),
                          device=device)
    return torch.sort(cand[perm[:n]]).values.to(torch.int32)


def weight_shapes(model: dict) -> list:
    """``[(layer, name, shape)]`` of the model's leaves, plan layer 0 (the
    logits) first: the GCN's ``w`` and ``b``; the R-GCN's ``w_self``,
    ``w_rel`` (one ``(d_in, d_out)`` a relation) and ``b``."""
    L = model["num_layers"]
    out = []
    for l in range(L):
        d_in = model["in_dim"] if l == L - 1 else model["hidden_dim"]
        d_out = model["num_classes"] if l == 0 else model["hidden_dim"]
        if model["kind"] == "gcn":
            out += [(l, "w", (d_in, d_out)), (l, "b", (d_out,))]
        elif model["kind"] == "rgcn":
            out += [(l, "w_self", (d_in, d_out)),
                    (l, "w_rel", (model["num_relations"], d_in, d_out)), (l, "b", (d_out,))]
        else:
            raise ValueError(f"unknown model kind {model['kind']!r}")
    return out


def weights(seed: int, model: dict, device) -> dict:
    """Glorot-uniform weights (fan in and out: the last two axes) and zero
    biases, from one draw of all leaves: ``{(layer, name): tensor}``."""
    shapes = weight_shapes(model)
    total = sum(math.prod(s) for _, n, s in shapes if n != "b")
    u = torch.rand(total, generator=generator(seed, WEIGHTS, device), device=device)
    out, at = {}, 0
    for l, name, shape in shapes:
        if name == "b":
            out[(l, name)] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        out[(l, name)] = ((2.0 * u[at:at + n] - 1.0) * lim).reshape(shape)
        at += n
    return out


def make(seed: int, config: dict, device) -> tuple:
    """``(graph, labels, train_ids, features, weights)`` of a configuration."""
    g, m = config["graph"], config["model"]
    ga = graph_of(seed, config, device)
    return (ga, labels(seed, ga.num_vertices, m["num_classes"], device),
            train_ids(seed, ga, g["train_fraction"], device),
            features(seed, ga.num_vertices, m["in_dim"], device), weights(seed, m, device))
