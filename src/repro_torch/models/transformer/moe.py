"""Mixture-of-Experts MLP with sort-based capacity dispatch; port of
``repro.models.transformer.moe``.

Tokens are routed top-k, grouped per expert by a stable sort (the same
owner-bucketing pattern as ``cooperative._bucketize``), processed as
dense (E, C, d) batched matmuls, and combined back with router weights.
Over-capacity tokens are dropped (standard capacity-factor semantics).
The routes (each token's experts, each expert's token table) are integer
state and equal the reference's bit for bit: ``jax.lax.top_k`` puts the
lower expert first among equal probabilities, and so does the stable
descending sort here.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.modules import _ACTS, scaled_normal, shard_hint


def init_moe(key: torch.Tensor, cfg: ArchConfig, device: Optional[torch.device] = None) -> dict:
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    ks = threefry.split(key, 4)
    s_in, s_out = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(f))
    p = {
        "router": scaled_normal(ks[0], (d, E), s_in, device),
        "w_up": scaled_normal(ks[1], (E, d, f), s_in, device),
        "w_down": scaled_normal(ks[2], (E, f, d), s_out, device),
    }
    if cfg.gated_mlp:
        p["w_gate"] = scaled_normal(ks[3], (E, d, f), s_in, device)
    return p


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots an expert takes from a group of ``tokens`` tokens."""
    C = int(np.ceil(tokens * cfg.moe_top_k / cfg.num_experts * cfg.moe_capacity_factor))
    return max(8, -(-C // 8) * 8)


class Routes(NamedTuple):
    """One group's routing: ``probs`` (T, E), ``expert`` (T, k), ``table_tok``
    (E, C) token per expert slot (-1 empty), ``table_gate`` (E, C) its
    normalized router weight (0 empty)."""

    probs: torch.Tensor
    expert: torch.Tensor
    table_tok: torch.Tensor
    table_gate: torch.Tensor


def route(p: Mapping, cfg: ArchConfig, xf: torch.Tensor) -> Routes:
    """Top-k routing and capacity dispatch of one group's tokens (T, d)."""
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.moe_top_k
    dev = xf.device
    logits = (xf @ p["router"]).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = top[:, :k], idx[:, :k]                # (T, k), ties to the lower expert
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    C = capacity(cfg, T)
    # flatten (token, slot) assignments and group by expert via stable sort
    flat_expert = expert.reshape(-1)                     # (T*k,)
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)
    flat_gate = gate.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_e = flat_expert[order]
    group_start = torch.searchsorted(sorted_e, torch.arange(E + 1, device=dev))
    rank = torch.arange(T * k, device=dev) - group_start[torch.clamp(sorted_e, 0, E)]
    ok = rank < C
    slot = torch.where(ok, sorted_e * C + rank, E * C)   # park overflow

    table_tok = torch.full((E * C + 1,), -1, dtype=torch.int32, device=dev)
    table_tok[slot] = torch.where(ok, flat_token[order].to(torch.int32), -1)
    table_gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    table_gate[slot] = torch.where(ok, flat_gate[order], 0.0)
    return Routes(probs, expert, table_tok[:E * C].reshape(E, C),
                  table_gate[:E * C].reshape(E, C))


def moe_apply(p: Mapping, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss scalar).

    Routing/dispatch runs per *group* (``cfg.moe_groups`` when it divides
    B): the argsort/capacity logic never crosses group boundaries.  The
    groups run one after another (the reference vmaps them).
    """
    B, S, d = x.shape
    G = cfg.moe_groups if B % max(cfg.moe_groups, 1) == 0 else 1
    if G > 1:
        xg = shard_hint(x.reshape(G, (B // G) * S, d), "batch", None, None)
        out, aux = _moe_groups(p, cfg, xg)
        out = shard_hint(out, "batch", None, None)
        return out.reshape(B, S, d), aux.mean()
    out, aux = _moe_group(p, cfg, x.reshape(B * S, d))
    return out.reshape(B, S, d), aux


def _loop_groups(p: Mapping, cfg: ArchConfig, xg: torch.Tensor) -> tuple:
    parts = [_moe_group(p, cfg, xx) for xx in xg]
    return torch.stack([o for o, _ in parts]), torch.stack([a for _, a in parts])


def _moe_groups(p: Mapping, cfg: ArchConfig, xg: torch.Tensor) -> tuple:
    """(G, T, d) groups -> ((G, T, d), aux (G,)), one group after another.

    Under a registered mesh (the dry-run) the groups are split over the
    batch dims and each device routes its own (``local_map``), as the
    reference's ``vmap`` over data-sharded groups does: the expert weights
    are all-gathered over the batch dims (expert-parallel or FSDP shards,
    written out here) and keep their ff split over the model dim, so each
    device's expert products are partial sums over the model dim, reduced
    by the hint after the groups."""
    from repro_torch.models.transformer import modules

    mesh = modules._LOGICAL_MESH
    from torch.distributed.tensor import DTensor

    if mesh is None or not isinstance(xg, DTensor):
        return _loop_groups(p, cfg, xg)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    keys = sorted(p)

    def weights(w):
        return tuple(pl if names[i] == "model" else Replicate()
                     for i, pl in enumerate(w.placements))

    x_pl = tuple(xg.placements)
    out_pl = tuple(Partial() if n == "model" else pl for n, pl in zip(names, x_pl))
    aux_pl = tuple(Replicate() if n == "model" else pl for n, pl in zip(names, x_pl))

    def local(xg_l, *ws):
        return _loop_groups(dict(zip(keys, ws)), cfg, xg_l)

    return local_map(local, out_placements=(out_pl, aux_pl),
                     in_placements=(x_pl, *(weights(p[k]) for k in keys)),
                     device_mesh=mesh, redistribute_inputs=True)(xg, *(p[k] for k in keys))


def _moe_group(p: Mapping, cfg: ArchConfig, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, d) -> ((T, d), aux)."""
    T, d = xf.shape
    E = cfg.num_experts
    r = route(p, cfg, xf)

    # load-balance auxiliary loss (Switch-style)
    one_hot = r.expert[:, :1] == torch.arange(E, device=xf.device)  # no sync, unlike bincount
    density = torch.mean(one_hot.float(), dim=0)
    density_prob = torch.mean(r.probs, dim=0)
    aux = E * torch.sum(density * density_prob)

    valid = r.table_tok >= 0
    xg = xf[torch.clamp(r.table_tok, min=0).long()]      # (E, C, d)
    xg = torch.where(valid[..., None], xg, 0.0)
    # the reference's expert-parallel hint (local tensors inside the
    # dry-run's per-device groups, so the identity there too)
    xg = shard_hint(xg, "expert", None, None)
    act = _ACTS[cfg.activation]
    if cfg.gated_mlp:
        h = act(torch.bmm(xg, p["w_gate"])) * torch.bmm(xg, p["w_up"])
    else:
        h = act(torch.bmm(xg, p["w_up"]))
    yg = torch.bmm(h, p["w_down"])                       # (E, C, d)
    yg = shard_hint(yg, "expert", None, None)
    yg = yg * r.table_gate[..., None].to(yg.dtype)

    out = torch.zeros((T + 1, d), dtype=yg.dtype, device=xf.device)
    out.index_add_(0, torch.where(valid, r.table_tok, T).reshape(-1).long(), yg.reshape(-1, d))
    return out[:T].to(xf.dtype), aux
