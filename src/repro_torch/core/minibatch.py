"""Independent minibatching (port of ``repro.core.minibatch``).

Builds an L-layer ``Minibatch`` plan from a seed frontier: frontiers
``S^0 ⊂ S^1 ⊂ ... ⊂ S^L`` (self-inclusive), one padded bipartite block
per layer with neighbor indices resolved *into the next frontier*, so the
forward pass is pure gathers.  Capacities come from :class:`CapacityPlan`
exactly as in the JAX package, so plan shapes match leaf by leaf.
:func:`layer_to_coo` gives the padded COO view of one block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import frontier
from repro_torch.core.graph import INVALID, Graph
from repro_torch.core.rng import DependentRNG
from repro_torch.core.samplers.base import Sampler


@dataclass(frozen=True)
class MinibatchLayer:
    """Bipartite block S~^{l+1} -> S^l with indices into frontier l+1."""

    seeds: torch.Tensor          # (cap_l,) dst vertex ids (= S^l), sorted+padded
    self_idx: torch.Tensor       # (cap_l,) position of each seed in S^{l+1}
    nbr_idx: torch.Tensor        # (cap_l, w) positions of sampled srcs in S^{l+1}
    mask: torch.Tensor           # (cap_l, w)
    etypes: Optional[torch.Tensor]  # (cap_l, w) relation ids or None


@dataclass(frozen=True)
class Minibatch:
    """L-layer plan; ``input_ids`` = S^L (the vertices whose features load)."""

    layers: tuple[MinibatchLayer, ...]
    input_ids: torch.Tensor  # (cap_L,)
    seed_ids: torch.Tensor   # (cap_0,) = layers[0].seeds

    def gather_inputs(self, store) -> torch.Tensor:
        """Input-layer embeddings from a :class:`FeatureStore`-like object."""
        return store.gather(self.input_ids)

    def stats(self) -> dict:
        """Per-layer counts: S{l}, E{l}, inputs, comm{l+1} (= 0).

        Scalars for a single plan; the max over the PE axis for a stacked
        plan.  One host transfer for all counts.
        """
        red = lambda x: x.max() if self.input_ids.ndim > 1 else x
        counts = [red((layer.seeds != INVALID).sum(-1)) for layer in self.layers]
        counts += [red(layer.mask.sum((-2, -1))) for layer in self.layers]
        counts.append(red((self.input_ids != INVALID).sum(-1)))
        vals = torch.stack(counts).tolist()
        L = len(self.layers)
        out = {}
        for l in range(L):
            out[f"S{l}"] = int(vals[l])
            out[f"E{l}"] = int(vals[L + l])
            out[f"comm{l+1}"] = 0  # independent mode never communicates
        out[f"S{L}"] = int(vals[2 * L])
        out["inputs"] = out[f"S{L}"]
        return out


@dataclass(frozen=True)
class CapacityPlan:
    """Frontier capacities cap_0..cap_L (geometric bound, Thm 3.2)."""

    caps: tuple[int, ...]

    @staticmethod
    def geometric(
        batch_size: int,
        num_layers: int,
        fanout: int,
        num_vertices: int,
        safety: float = 1.25,
        round_to: int = 8,
    ) -> "CapacityPlan":
        caps = [batch_size]
        for _ in range(num_layers):
            nxt = min(int(caps[-1] * (fanout + 1) * safety), num_vertices)
            nxt = -(-nxt // round_to) * round_to
            caps.append(nxt)
        return CapacityPlan(tuple(caps))

    def __getitem__(self, l: int) -> int:
        return self.caps[l]


def build_minibatch(
    graph: Graph,
    sampler: Sampler,
    seeds: torch.Tensor,
    rng: DependentRNG,
    num_layers: int,
    caps: CapacityPlan,
    backend: str = "reference",
) -> Minibatch:
    """Sample an L-layer minibatch plan (independent path).

    ``backend="reference"`` is the plain torch sort/searchsorted algebra;
    ``"fused"`` routes dedup + rank resolution through the
    ``unique_compact`` kernel and the neighbor expansion through
    ``frontier_gather`` (on CUDA tensors).  Outputs are bit-identical.
    """
    frontier._check_backend(backend)
    S_l = frontier.unique_compact(seeds, caps[0], backend=backend)
    layers = []
    for l in range(num_layers):
        ls = sampler.sample_layer(graph, S_l, rng, l)
        cat = torch.cat([S_l, ls.nbr.reshape(-1)])
        S_next, inv = frontier.unique_with_inverse(cat, caps[l + 1], backend=backend)
        n = S_l.shape[0]
        self_idx = inv[:n]
        nbr_idx = inv[n:].reshape(ls.nbr.shape)
        layers.append(
            MinibatchLayer(
                seeds=S_l,
                self_idx=self_idx,
                nbr_idx=nbr_idx,
                mask=ls.mask & (nbr_idx >= 0),
                etypes=ls.etypes,
            )
        )
        S_l = S_next
    return Minibatch(layers=tuple(layers), input_ids=S_l, seed_ids=layers[0].seeds)


def layer_to_coo(
    layer,
    cap_edges: int,
    backend: str = "reference",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded COO view of one bipartite block for plan-local assembly.

    ``layer`` is one (unstacked) plan layer: anything with an ``(n, w)``
    ``mask`` and ``nbr_idx``.  Returns ``(rows, cols, indptr)``:
    ``indptr`` (n+1,) counts valid edges per dst row; ``rows[e]``/``cols[e]``
    give the dst row and the src position (into ``S^{l+1}``) of edge slot
    ``e`` in row-major mask order, ``-1`` past the total edge count.  Edges
    beyond ``cap_edges`` are dropped deterministically (callers size
    ``cap_edges`` at ``n * w`` so this never fires).  ``"fused"`` computes
    ``rows`` with the ``expand_indptr`` kernel (on a CUDA tensor); both
    backends are bit-identical.
    """
    frontier._check_backend(backend)
    mask = layer.mask
    dev = mask.device
    counts = mask.sum(dim=1).to(torch.int32)
    indptr = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(counts, 0).to(torch.int32)])
    if backend == "fused":
        from repro_torch import kernels

        rows = kernels.expand_indptr(indptr, cap_edges)
    else:
        from repro_torch.kernels.expand_indptr.ref import expand_indptr_ref

        rows = expand_indptr_ref(indptr, cap_edges)
    pos = torch.cumsum(mask, dim=1).to(torch.int32) - 1
    flat = indptr[:-1, None] + pos
    # dropped and masked slots all go to a ghost slot one past the end, so
    # no kept index repeats
    flat = torch.where(mask & (flat < cap_edges), flat, cap_edges)
    cols = torch.full((cap_edges + 1,), -1, dtype=torch.int32, device=dev)
    cols[flat.reshape(-1).long()] = torch.where(mask, layer.nbr_idx, -1).reshape(-1)
    cols = cols[:cap_edges]
    rows = torch.where(cols >= 0, rows, -1)
    return rows, cols, indptr
