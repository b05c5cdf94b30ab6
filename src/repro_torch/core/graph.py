"""CSR graph container in torch tensors (port of ``repro.core.graph``).

The graph stores *incoming* edges in CSR form: for vertex ``s`` the
in-neighborhood ``N(s) = {t | (t -> s) in E}`` lives at
``indices[indptr[s] : indptr[s+1]]`` (embeddings flow t -> s).

Every sampling path works on *degree-capped* neighbor tables of shape
``(num_seeds, max_degree)``; ``Graph.from_edges`` down-samples
over-capacity neighborhoods with the same numpy draw as the JAX package,
so both packages build identical graphs from the same edge list.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

INVALID = int(np.iinfo(np.int32).max)  # padding sentinel for vertex ids


class GraphValidationError(ValueError):
    """A CSR graph failed well-formedness checks (see Graph.validate)."""

    def __init__(self, problems: list):
        self.problems = list(problems)
        super().__init__("malformed CSR graph: " + "; ".join(self.problems))


@dataclass(frozen=True)
class Graph:
    """CSR graph of in-edges.

    Attributes:
      indptr:  (V+1,) int32 row pointer over destination vertices.
      indices: (E,)   int32 source vertex of each in-edge.
      edge_types: optional (E,) int32 relation ids.
      max_degree: max in-degree (after capping).
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    edge_types: Optional[torch.Tensor]
    max_degree: int
    num_vertices: int
    num_edges: int
    num_edge_types: int

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to(self, device: DeviceLike) -> "Graph":
        """Same graph with its arrays on ``device`` (no copy if already there)."""
        dev = resolve_device(device)
        move = lambda t: None if t is None else t.to(dev)
        return replace(
            self, indptr=move(self.indptr), indices=move(self.indices),
            edge_types=move(self.edge_types),
        )

    def validate(self) -> "Graph":
        """Check CSR well-formedness; raise GraphValidationError if broken."""
        problems = []
        V, E = self.num_vertices, self.num_edges
        if self.indptr.dtype != torch.int32:
            problems.append(f"indptr dtype {self.indptr.dtype} != int32")
        if self.indices.dtype != torch.int32:
            problems.append(f"indices dtype {self.indices.dtype} != int32")
        if tuple(self.indptr.shape) != (V + 1,):
            problems.append(
                f"indptr shape {tuple(self.indptr.shape)} != ({V + 1},) "
                f"for num_vertices={V}"
            )
        if tuple(self.indices.shape) != (E,):
            problems.append(
                f"indices shape {tuple(self.indices.shape)} != ({E},) "
                f"for num_edges={E}"
            )
        if self.edge_types is not None and tuple(self.edge_types.shape) != (E,):
            problems.append(
                f"edge_types shape {tuple(self.edge_types.shape)} != ({E},)"
            )
        if problems:  # shape/dtype errors make the value checks undefined
            raise GraphValidationError(problems)

        first, last = int(self.indptr[0]), int(self.indptr[-1])
        if first != 0:
            problems.append(f"indptr[0] == {first} != 0")
        if last != E:
            problems.append(f"indptr[-1] == {last} != num_edges ({E})")
        deg = self.degrees
        n_nonmono = int((deg < 0).sum())
        max_deg = int(deg.max()) if deg.numel() else 0
        if n_nonmono:
            problems.append(
                f"indptr not monotone non-decreasing at {n_nonmono} row(s)"
            )
        elif max_deg > self.max_degree:
            problems.append(
                f"max in-degree {max_deg} exceeds declared "
                f"max_degree={self.max_degree}"
            )
        if E:
            n_oob = int(((self.indices < 0) | (self.indices >= V)).sum())
            if n_oob:
                problems.append(f"{n_oob} edge indices outside [0, {V})")
        if self.edge_types is not None and E:
            n_bad_et = int((
                (self.edge_types < 0)
                | (self.edge_types >= self.num_edge_types)
            ).sum())
            if n_bad_et:
                problems.append(
                    f"{n_bad_et} edge types outside [0, {self.num_edge_types})"
                )
        if problems:
            raise GraphValidationError(problems)
        return self

    @staticmethod
    def from_edges(
        src: np.ndarray,
        dst: np.ndarray,
        num_vertices: int,
        edge_types: Optional[np.ndarray] = None,
        max_degree: Optional[int] = None,
        num_edge_types: int = 1,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> "Graph":
        """Build an in-CSR graph from a (t -> s) edge list (host-side numpy)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        if edge_types is not None:
            edge_types = np.asarray(edge_types)[order]
        counts = np.bincount(dst, minlength=num_vertices)
        cap = int(max_degree) if max_degree is not None else int(counts.max(initial=0))
        if counts.max(initial=0) > cap:
            # Down-sample over-capacity neighborhoods (same draw as the JAX package).
            rng = np.random.default_rng(seed)
            keep = np.ones(len(src), dtype=bool)
            indptr_full = np.zeros(num_vertices + 1, dtype=np.int64)
            np.cumsum(counts, out=indptr_full[1:])
            for v in np.nonzero(counts > cap)[0]:
                sl = slice(indptr_full[v], indptr_full[v + 1])
                drop = rng.choice(counts[v], size=counts[v] - cap, replace=False)
                keep_v = np.ones(counts[v], dtype=bool)
                keep_v[drop] = False
                keep[sl] = keep_v
            src, dst = src[keep], dst[keep]
            if edge_types is not None:
                edge_types = edge_types[keep]
            counts = np.bincount(dst, minlength=num_vertices)
        indptr = np.zeros(num_vertices + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        dev = resolve_device(device)
        return Graph(
            indptr=torch.from_numpy(indptr).to(dev),
            indices=torch.from_numpy(src.astype(np.int32)).to(dev),
            edge_types=None if edge_types is None
            else torch.from_numpy(np.asarray(edge_types, np.int32)).to(dev),
            max_degree=int(min(cap, counts.max(initial=0))) or 1,
            num_vertices=int(num_vertices),
            num_edges=int(len(src)),
            num_edge_types=int(num_edge_types),
        )

    def neighbor_table(
        self, seeds: torch.Tensor, backend: str = "reference"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather the (padded) in-neighborhoods of ``seeds``.

        Args:
          seeds: (n,) int32 vertex ids, INVALID-padded.
          backend: "reference" (plain torch gather) or "fused" (the
            :mod:`repro_torch.kernels.frontier_gather` CUDA kernel on a
            CUDA tensor) -- bit-identical outputs.
        Returns:
          nbr:  (n, max_degree) int32 source ids, INVALID where padded.
          mask: (n, max_degree) bool validity.
        """
        if backend == "fused":
            from repro_torch.kernels import frontier_gather

            return frontier_gather(
                self.indptr, self.indices, seeds, self.max_degree
            )
        return _neighbor_table(self.indptr, self.indices, seeds, self.max_degree)

    def neighbor_edge_types(self, seeds: torch.Tensor) -> torch.Tensor:
        """(n, max_degree) int32 relation ids aligned with neighbor_table."""
        assert self.edge_types is not None
        safe = torch.where(seeds == INVALID, 0, seeds).long()
        offs = self.indptr[safe]
        deg = self.indptr[safe + 1] - offs
        pos = torch.arange(self.max_degree, dtype=torch.int32,
                           device=seeds.device)[None, :]
        idx = (offs[:, None] + pos).clamp(0, max(self.num_edges - 1, 0))
        et = self.edge_types[idx.long()]
        valid = (pos < deg[:, None]) & (seeds != INVALID)[:, None]
        return torch.where(valid, et, 0)


def _neighbor_table(indptr, indices, seeds, max_degree):
    """Plain torch neighbor-table expansion (the ``reference`` backend)."""
    from repro_torch.kernels.frontier_gather.ref import frontier_gather_ref

    return frontier_gather_ref(indptr, indices, seeds, max_degree)
