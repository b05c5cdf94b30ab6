"""Cooperative Minibatching (§3.1, Algorithm 1), port of ``repro.core.cooperative``.

One *global* minibatch of size ``B = b·P`` is processed by all ``P`` PEs
together.  The graph is 1-D partitioned (a vertex and its in-edges are
owned by one PE).  Every sampling hop and every forward/backward layer
redistributes vertex ids, embeddings and gradients to owner PEs with an
all-to-all.

Executors: the same per-PE code runs under two.

* :class:`SimExecutor` stacks the PEs on a leading axis ``(P, ...)`` on
  one device.  Its ``pe`` runs the per-PE body in a Python loop over the
  PEs and stacks the results: the bodies call ``torch.unique``,
  data-dependent sorts and the ctypes kernels, which ``torch.func.vmap``
  cannot batch, and the loop gives the same integers as JAX's ``vmap``.
  The all-to-all is an axis transpose.
* :class:`ShardExecutor` is one process per PE in a ``torch.distributed``
  process group (the rank is the PE): ``pe`` calls the body on this
  rank's own data, with no PE axis, and the all-to-all is
  ``all_to_all_single`` (NCCL between cards, or gloo).

Autograd through the exchange and through :func:`redistribute`'s gather
and scatter gives the backward all-to-alls of Alg. 1.

Exchange convention: each PE holds a buffer ``x`` of shape
``(P, cap, ...)`` whose slice ``x[q]`` is destined for PE ``q``;
``exchange`` returns ``y`` with ``y[q]`` = what PE ``q`` sent here.

Static shapes: bucket capacities are fixed; over-capacity vertices are
dropped deterministically (counted in :func:`plan_stats`).
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol

import torch
import torch.distributed as dist

from repro_torch.core import frontier
from repro_torch.core.graph import INVALID, Graph
from repro_torch.core.partition import Partition
from repro_torch.core.samplers.base import Sampler
from repro_torch.utils.spans import count, mark_backward, span


# --------------------------------------------------------------------------
# Executors
# --------------------------------------------------------------------------
class Executor(Protocol):
    num_pes: int

    def pe(self, fn: Callable, *args):
        """Run a per-PE function on every PE."""

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Bucketed all-to-all; see the module docstring for the convention."""


def _stack(outs: list):
    """Stack per-PE results leaf by leaf (tensors, tuples, dataclasses, None)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, tuple):
        return tuple(_stack([o[i] for o in outs]) for i in range(len(first)))
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _stack([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(first)
        })
    raise TypeError(f"cannot stack per-PE results of type {type(first)}")


@dataclass(frozen=True)
class SimExecutor:
    """Single-device simulation: PEs = stacked leading axis, A2A = swap."""

    num_pes: int

    def pe(self, fn, *args):
        return _stack([fn(*(a[p] for a in args)) for p in range(self.num_pes)])

    def exchange(self, x):
        # x: (P_src, P_dst, cap, ...) stacked over source PEs
        return x.transpose(0, 1).contiguous()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``y[q]`` = what rank ``q`` sent here, for ``x`` of shape ``(P, ...)``."""
    x = x.contiguous()
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x, group=group)
    return y


class _Exchange(torch.autograd.Function):
    """The embedding all-to-all; its backward is the same all-to-all of the
    gradients (the exchange is its own transpose: rank q's slice p comes
    back to rank p as slice q), the last loop of Alg. 1."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


@dataclass(frozen=True)
class ShardExecutor:
    """One PE per rank of a ``torch.distributed`` process group of
    ``num_pes`` ranks: ``pe`` runs the body on this rank's data (no
    leading PE axis, as JAX's ``ShardExecutor`` inside ``shard_map``),
    ``exchange`` is ``all_to_all_single`` over ``group`` and carries
    autograd."""

    num_pes: int
    group: Any = None  # None: the default process group

    def pe(self, fn, *args):
        return fn(*args)

    def exchange(self, x):
        if x.shape[0] != self.num_pes:
            raise ValueError(f"exchange buffer has {x.shape[0]} slices, want {self.num_pes}")
        if x.requires_grad:
            return _Exchange.apply(x, self.group)
        return _all_to_all(x, self.group)


# --------------------------------------------------------------------------
# Plan structures
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class CoopLayer:
    """One cooperative layer: local block + cached exchange mappings.

    The forward pass converts owned embeddings ``H`` (rows = S^{l+1}) into
    request-side embeddings ``H~`` (rows = S~^{l+1}) with
    :func:`redistribute`; the bipartite compute then uses local indices.
    """

    seeds: torch.Tensor          # (cap_l,) owned dst ids S_p^l
    self_idx: torch.Tensor       # (cap_l,) into S~^{l+1}
    nbr_idx: torch.Tensor        # (cap_l, w) into S~^{l+1}
    mask: torch.Tensor           # (cap_l, w)
    etypes: Optional[torch.Tensor]
    slot_to_tilde: torch.Tensor  # (P, cap_bucket) scatter: bucket slot -> S~ row
    req_idx: torch.Tensor        # (P, cap_bucket) gather: peer request -> S^{l+1} row
    tilde_ids: torch.Tensor      # (cap_tilde,) S~^{l+1} vertex ids


@dataclass(frozen=True)
class CoopMinibatch:
    """Cooperative L-layer plan (the :class:`repro_torch.engine.Plan`
    protocol).  Under :class:`SimExecutor` every leaf has a leading
    ``(P, ...)`` axis."""

    layers: tuple[CoopLayer, ...]
    input_ids: torch.Tensor  # (cap_L,) owned S_p^L -- features this PE fetches
    seed_ids: torch.Tensor

    def gather_inputs(self, store) -> torch.Tensor:
        """Owned input embeddings (no cross-PE duplication, Fig. 7b)."""
        return store.gather(self.input_ids)

    def stats(self) -> dict:
        """Per-PE max counts (Table 7).  Requires the stacked Sim layout."""
        if self.seed_ids.ndim != 2 or self.layers[0].slot_to_tilde.ndim != 3:
            raise ValueError(
                "CoopMinibatch.stats() needs the stacked SimExecutor layout; plans "
                "built per rank under ShardExecutor have no global view"
            )
        return plan_stats(self, SimExecutor(self.seed_ids.shape[0]))


@dataclass(frozen=True)
class CoopCapacityPlan:
    """Static capacities: owned frontier, request frontier, A2A bucket."""

    caps: tuple[int, ...]         # owned S_p^l capacity, l = 0..L
    tilde_caps: tuple[int, ...]   # S~_p^{l+1} capacity, l = 0..L-1
    bucket_caps: tuple[int, ...]  # per-peer A2A bucket, l = 0..L-1

    @staticmethod
    def geometric(
        local_batch: int,
        num_layers: int,
        fanout: int,
        num_vertices: int,
        num_pes: int,
        safety: float = 1.5,
        bucket_safety: float = 2.5,
        round_to: int = 8,
    ) -> "CoopCapacityPlan":
        rnd = lambda x: -(-int(x) // round_to) * round_to
        caps = [rnd(local_batch)]
        tilde, buckets = [], []
        for _ in range(num_layers):
            t = min(rnd(caps[-1] * (fanout + 1) * safety), num_vertices)
            tilde.append(t)
            buckets.append(rnd(t // num_pes * bucket_safety + fanout))
            caps.append(min(rnd(t * safety), num_vertices))
        return CoopCapacityPlan(tuple(caps), tuple(tilde), tuple(buckets))


# --------------------------------------------------------------------------
# Plan building (cooperative sampling -- Alg. 1, first loop)
# --------------------------------------------------------------------------
def _bucketize(ids: torch.Tensor, owners: torch.Tensor, num_pes: int, cap_bucket: int):
    """Partition a padded id vector into per-owner buckets.

    Returns (bucket_ids (P, cap), slot_to_src (P, cap)) where slot_to_src
    maps each bucket slot back to its position in ``ids`` (-1 padding).
    Dropped and padding entries all write to one ghost slot past the end,
    which is cut off, so every kept slot is written exactly once (a
    repeated index in ``index_put_`` has no defined winner on CUDA).
    """
    n, dev = ids.shape[0], ids.device
    valid = ids != INVALID
    owners = torch.where(valid, owners, num_pes).to(torch.int32)  # ghost bucket
    order = torch.argsort(owners, stable=True)
    sorted_owner = owners[order]
    sorted_ids = ids[order]
    group_start = torch.searchsorted(
        sorted_owner, torch.arange(num_pes + 1, dtype=torch.int32, device=dev)
    )
    rank = torch.arange(n, device=dev) - group_start[sorted_owner.clamp(0, num_pes).long()]
    ok = (sorted_owner < num_pes) & (rank < cap_bucket)
    ghost = num_pes * cap_bucket
    flat_pos = torch.where(ok, sorted_owner.long() * cap_bucket + rank, ghost)
    bucket_ids = torch.full((ghost + 1,), INVALID, dtype=ids.dtype, device=dev)
    bucket_ids[flat_pos] = torch.where(ok, sorted_ids, INVALID)
    slot_to_src = torch.full((ghost + 1,), -1, dtype=torch.int32, device=dev)
    slot_to_src[flat_pos] = torch.where(ok, order.to(torch.int32), -1)
    return (
        bucket_ids[:ghost].reshape(num_pes, cap_bucket),
        slot_to_src[:ghost].reshape(num_pes, cap_bucket),
    )


def build_cooperative_minibatch(
    graph: Graph,
    sampler: Sampler,
    part: Partition,
    seeds: torch.Tensor,  # per-PE owned seed frontier, stacked (P, b)
    rng,
    num_layers: int,
    caps: CoopCapacityPlan,
    ex: Executor,
    backend: str = "reference",
) -> CoopMinibatch:
    """Sample a cooperative plan; every leaf equals the JAX package's."""
    frontier._check_backend(backend)
    P = ex.num_pes

    def local_seeds(s):
        return frontier.unique_compact(s, caps.caps[0], backend=backend)

    S_l = ex.pe(local_seeds, seeds)
    layers = []
    for l in range(num_layers):
        cap_t, cap_b, cap_next = caps.tilde_caps[l], caps.bucket_caps[l], caps.caps[l + 1]

        def sample_and_bucket(S):
            ls = sampler.sample_layer(graph, S, rng, l)
            cat = torch.cat([S, ls.nbr.reshape(-1)])
            tilde, inv = frontier.unique_with_inverse(cat, cap_t, backend=backend)
            self_idx = inv[: S.shape[0]]
            nbr_idx = inv[S.shape[0]:].reshape(ls.nbr.shape)
            owners = part.owner_of(tilde)
            bucket_ids, slot_to_tilde = _bucketize(tilde, owners, P, cap_b)
            return ls.mask, ls.etypes, tilde, nbr_idx, self_idx, bucket_ids, slot_to_tilde

        mask, etypes, tilde, nbr_idx, self_idx, bucket_ids, slot_to_tilde = ex.pe(
            sample_and_bucket, S_l
        )
        with span(f"exchange.ids.l{l}"):
            req = ex.exchange(bucket_ids)  # ids owned here, requested per peer
        count(f"exchange.id_bytes.l{l}", bucket_ids.numel() * bucket_ids.element_size())

        def next_frontier(req):
            # one dedup resolves both the next owned frontier and every
            # peer request slot
            S_next, inv = frontier.unique_with_inverse(
                req.reshape(-1), cap_next, backend=backend
            )
            return S_next, inv.reshape(req.shape)

        S_next, req_idx = ex.pe(next_frontier, req)
        layers.append(
            CoopLayer(
                seeds=S_l,
                self_idx=self_idx,
                nbr_idx=nbr_idx,
                mask=mask & (nbr_idx >= 0),
                etypes=etypes,
                slot_to_tilde=slot_to_tilde,
                req_idx=req_idx,
                tilde_ids=tilde,
            )
        )
        S_l = S_next
    return CoopMinibatch(layers=tuple(layers), input_ids=S_l, seed_ids=layers[0].seeds)


# --------------------------------------------------------------------------
# Embedding redistribution (Alg. 1 forward loop; backward by autograd)
# --------------------------------------------------------------------------
def redistribute(
    ex: Executor, layer: CoopLayer, H: torch.Tensor, cap_tilde: int,
    l: Optional[int] = None,
) -> torch.Tensor:
    """Convert owned embeddings H (rows = S^{l+1}) to H~ (rows = S~^{l+1}).

    Differentiable: autograd through the request gather (an accumulating
    scatter where several peers request one row), the exchange and the
    slot scatter yields the backward all-to-all of Alg. 1.

    With the layer's index ``l``, the whole of it is the span
    ``exchange.fwd.l{l}`` and its backward ``exchange.bwd.l{l}``, and it
    counts the bytes of its exchange's slots (one row of H each) and of
    the valid ones (:mod:`repro_torch.utils.spans`).
    """
    traced = l is not None
    if traced:
        count(f"exchange.slot_bytes.l{l}",
              layer.slot_to_tilde.numel() * H.shape[-1] * H.element_size())
    with span(f"exchange.fwd.l{l}") if traced else nullcontext():
        if traced:
            H = mark_backward(H, f"exchange.bwd.l{l}", end=True)
        send = ex.pe(frontier.take_rows, H, layer.req_idx)  # (P, P, cap_b, d)
        recv = ex.exchange(send)

        def scatter(recv, slot_to_tilde):
            d = recv.shape[-1]
            valid = slot_to_tilde >= 0
            if traced:  # the bytes of the valid slots, from the same mask
                count(f"exchange.valid_bytes.l{l}",
                      lambda: valid.sum() * (d * recv.element_size()))
            pos = torch.where(valid, slot_to_tilde, cap_tilde).reshape(-1)
            out = recv.new_zeros((cap_tilde + 1, d))
            out = out.index_put((pos.long(),), recv.reshape(-1, d))
            return out[:cap_tilde]

        out = ex.pe(scatter, recv, layer.slot_to_tilde)
    return mark_backward(out, f"exchange.bwd.l{l}", end=False) if traced else out


def plan_stats(mb: CoopMinibatch, ex: Executor) -> dict:
    """Per-PE max counts (Table 7 columns): |S^l|, |E^l|, |S~^l|, c|S~^l|.

    Only meaningful under :class:`SimExecutor` (stacked PE axis); one host
    transfer for all counts.
    """
    if not isinstance(ex, SimExecutor):
        raise TypeError(
            "plan_stats needs the SimExecutor's stacked layout; a ShardExecutor "
            "rank holds only its own plan (ShardRunner.stack_plan gathers them)"
        )
    P = ex.num_pes
    off_diag = ~torch.eye(P, dtype=torch.bool, device=mb.seed_ids.device)
    names, vals = [], []
    for l, layer in enumerate(mb.layers):
        filled = layer.slot_to_tilde >= 0  # (P, P, cap_b)
        names += [f"S{l}", f"E{l}", f"tilde{l+1}", f"comm{l+1}"]
        vals += [
            (layer.seeds != INVALID).sum(-1).max(),
            layer.mask.sum((-2, -1)).max(),
            filled.sum((-2, -1)).max(),
            (filled & off_diag[:, :, None]).sum((-2, -1)).max(),
        ]
    names.append("inputs")
    vals.append((mb.input_ids != INVALID).sum(-1).max())
    return dict(zip(names, (int(v) for v in torch.stack(vals).tolist())))
