"""Grouped-query attention: training (full-sequence) and decode (KV cache);
port of ``repro.models.transformer.attention``.

Conventions:
  x:       (B, S, d_model)
  q/k/v:   (B, S, H|KV, head_dim)
  cache:   dict(k=(B, S_max, KV, hd), v=...), one per attention layer
All masking is static-shape; decode masks by position index against the
current length, a device tensor, so one decode step serves every position
and never waits on the host.  The products are ``torch.einsum``/``@`` in
float32; the softmaxes, masks and the online-softmax recurrence are the
reference's own (no fused library attention: its masking and the logit
softcap differ).
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.modules import (
    _reduced,
    apply_rope,
    model_dim,
    on_mesh_dim,
    rope_freqs,
    scaled_normal,
    shard_hint,
    softcap,
)


def init_attention(key: torch.Tensor, cfg: ArchConfig, cross: bool = False,
                   device: Optional[torch.device] = None) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    ks = threefry.split(key, 4)
    s = float(1.0 / np.sqrt(d))
    so = float(1.0 / np.sqrt(H * hd))
    return {
        "wq": scaled_normal(ks[0], (d, H * hd), s, device),
        "wk": scaled_normal(ks[1], (d, KV * hd), s, device),
        "wv": scaled_normal(ks[2], (d, KV * hd), s, device),
        "wo": scaled_normal(ks[3], (H * hd, d), so, device),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _mesh_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, H: int, KV: int,
                 seq_dim: Optional[int] = 1) -> tuple:
    """Model-dim placements of the projections ``x @ w`` (..., n*hd) that
    reshape to heads under a registered mesh (the dry-run); with no mesh,
    or plain tensors, they come back as they are.

    Column-parallel projections are sharded over the model dim.  Where the
    heads divide it, the shards reshape to whole heads (Megatron).  Where
    they do not (gemma2-2b's 8 query heads on a 16-way dim), a shard of
    ``n*hd`` columns is part of a head, which a DTensor cannot reshape:
    queries move to a sequence shard over the model dim (one all-to-all;
    with ``seq_dim=None``, a one-token decode, an all-gather) and keys and
    values are all-gathered over it, so the score and value products stay
    split over the model dim by query position."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    md = model_dim()
    if md is None or not isinstance(q, DTensor):
        return q, k, v
    mesh, mi = md
    msz = mesh.shape[mi]

    def on_model(t, pl):
        if not isinstance(t, DTensor) or t.placements[mi] == pl:
            return t
        return on_mesh_dim(t, mesh, mi, pl)

    if H % msz or (seq_dim is None and KV % msz):
        # a one-token decode against a cache split over head_dim takes
        # whole queries (a local slice of head_dim follows)
        seq_ok = seq_dim is not None and q.shape[seq_dim] % msz == 0
        q = on_model(q, Shard(seq_dim) if seq_ok else Replicate())
    if KV % msz or H % msz:
        k, v = on_model(k, Replicate()), on_model(v, Replicate())
    return q, k, v


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H*hd), the input of the output projection.

    Under a registered mesh a DTensor split over ``hd`` (a decode against
    a cache sharded on its head dim) is all-gathered over the model dim
    first (a column shard of ``H*hd`` is not a whole-``hd`` split), and
    one split by query position (:func:`_mesh_layout`) moves back to
    column shards (one all-to-all): the row-parallel ``wo`` then sums
    over the model dim, as with head-sharded attention."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    md = model_dim()
    sharded = md is not None and isinstance(out, DTensor)
    if sharded and out.placements[md[1]] == Shard(out.ndim - 1):
        out = on_mesh_dim(out, *md, Replicate())
    out = out.reshape(*out.shape[:-2], out.shape[-2] * out.shape[-1])
    if sharded:
        # column shards (from a split by position: one all-to-all), and the
        # gradient from the row-parallel product taken as it comes
        out = shard_hint(out, "batch", *([None] * (out.ndim - 2)), "model")
    return out


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd), each KV head repeated in
    place (``jnp.repeat`` along axis 2)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _flash_attention(
    q: torch.Tensor,   # (B, S, H, hd) roped
    k: torch.Tensor,   # (B, S, H, hd) roped+repeated
    v: torch.Tensor,
    window: Optional[int],
    attn_softcap: Optional[float],
    block_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over key blocks (the reference's scan as a
    loop).  Never materializes (S, S) scores: the peak intermediate is
    (B, S, H, block_k).  Causal / sliding-window masking per block."""
    B, S, H, hd = q.shape
    blk = min(block_k, S)
    assert S % blk == 0
    nb = S // blk
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    q_pos = torch.arange(S, device=dev)
    # bfloat16 queries meet float32 keys as jnp.einsum promotes them
    qf, kf, vf = q.float(), k.float(), v.float()
    # placed like the queries when they are DTensors (the dry-run)
    acc = torch.zeros_like(q, dtype=torch.float32)
    m = torch.full_like(q[..., 0], -torch.inf, dtype=torch.float32)
    l = torch.zeros_like(q[..., 0], dtype=torch.float32)
    for j in range(nb):
        k_j, v_j = kf[:, j * blk:(j + 1) * blk], vf[:, j * blk:(j + 1) * blk]
        s = torch.einsum("bqhd,bkhd->bqhk", qf, k_j) * scale  # (B,S,H,blk)
        if attn_softcap:
            s = softcap(s, attn_softcap)
        k_pos = j * blk + torch.arange(blk, device=dev)
        ok = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            ok &= k_pos[None, :] > (q_pos[:, None] - window)
        s = torch.where(ok[None, :, None, :], s, -1e9)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, v_j)
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)


def _banded_local_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    attn_softcap: Optional[float],
) -> torch.Tensor:
    """Exact sliding-window attention in O(S·2W): queries blocked by
    window, block i attending key blocks {i-1, i} with an in-band
    causal/window mask."""
    B, S, H, hd = q.shape
    W = window
    assert S % W == 0, (S, W)
    nw = S // W
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    qb = q.reshape(B, nw, W, H, hd)
    kb = k.reshape(B, nw, W, H, hd)
    vb = v.reshape(B, nw, W, H, hd)
    # previous key/value block (zeros for the first)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)  # (B,nw,2W,H,hd)
    v2 = torch.cat([v_prev, vb], dim=2)
    s = torch.einsum("bnqhd,bnkhd->bnqhk", qb, k2) * scale  # (B,nw,W,H,2W)
    if attn_softcap:
        s = softcap(s, attn_softcap)
    q_pos = torch.arange(W, device=dev)[:, None]          # within-block query offset
    k_pos = torch.arange(2 * W, device=dev)[None, :] - W  # key offset relative to block
    ok = (k_pos <= q_pos) & (k_pos > q_pos - W)
    first_block = torch.arange(nw, device=dev) == 0       # no previous block to see
    ok_first = ok & (k_pos >= 0)
    mask = torch.where(first_block[:, None, None], ok_first[None], ok[None])
    s = torch.where(mask[None, :, :, None, :], s, -1e9)
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bnqhk,bnkhd->bnqhd", w, v2)
    return out.reshape(B, S, H, hd)


def attention_train(
    p: Mapping,
    cfg: ArchConfig,
    x: torch.Tensor,              # (B, S, d)
    positions: torch.Tensor,      # (S,) shared across batch rows
    window: Optional[int],        # None = global
) -> torch.Tensor:
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B, S, _ = x.shape
    q, k, v = _mesh_layout(x @ p["wq"], x @ p["wk"], x @ p["wv"], H, KV)
    q, k, v = _split_heads(q, H, hd), _split_heads(k, KV, hd), _split_heads(v, KV, hd)
    sin, cos = rope_freqs(positions[None, :], hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    if window is not None and S > 2 * window and S % window == 0:
        core = functools.partial(_banded_local_attention, window=window,
                                 attn_softcap=cfg.attn_softcap)
        q = _whole_sequence(q)
    else:
        core = functools.partial(_flash_attention, window=window, attn_softcap=cfg.attn_softcap)
    return _reduced(_merge_heads(_per_head(core, q, k, v)) @ p["wo"])


def _whole_sequence(q: torch.Tensor) -> torch.Tensor:
    """Under a registered mesh, queries split by position over the model
    dim (:func:`_mesh_layout`) are all-gathered over it: the banded path's
    windows cross those shards.  The banded products of such a layer then
    run whole on every model rank (heads that do not divide the model dim
    leave no other split to DTensor here)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    md = model_dim()
    if md is not None and isinstance(q, DTensor) and q.placements[md[1]] == Shard(1):
        return on_mesh_dim(q, *md, Replicate())
    return q


def _per_head(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` on (B, S, H, hd) tensors.  Under a registered mesh
    with the queries split over heads on the model dim (Megatron: the
    heads divide it), the attention of each head is its own: ``fn`` runs
    on each device's local heads (``local_map``; keys and values placed
    like the queries, a local slice where they were whole).  DTensor's
    own ``einsum`` would flatten the batch and head dims into one dim
    split over two mesh dims, which its batched product cannot take."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    md = model_dim()
    if md is None or not isinstance(q, DTensor) or q.placements[md[1]] != Shard(2):
        return fn(q, k, v)
    pl = tuple(q.placements)
    return local_map(fn, out_placements=(pl,), in_placements=(pl, pl, pl), device_mesh=md[0],
                     redistribute_inputs=True)(q, k, v)


def attention_decode(
    p: Mapping,
    cfg: ArchConfig,
    x: torch.Tensor,         # (B, 1, d)
    cache: dict,             # {'k': (B, S_c, KV, hd), 'v': ...}
    pos: torch.Tensor,       # () current position (same for whole batch), on the device
    window: Optional[int],
    ring: bool = False,
) -> tuple[torch.Tensor, dict]:
    """One-token attention against a KV cache, updated in place.

    ``ring=True`` treats the cache as a rotating window buffer of length
    ``S_c == window``: slot ``pos % S_c`` is overwritten, slot ``i`` holds
    the key of absolute position ``pos - ((pos - i) mod S_c)``.  Otherwise
    the new key goes to slot ``min(pos, S_c - 1)``, clamped as the
    reference's ``dynamic_update_slice`` clamps its start.  The slot stays
    a device tensor (``index_copy_``), so the step never waits on the
    host.  Returns the output and the cache (the same tensors).
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    S = cache["k"].shape[1]
    q, k_new, v_new = _mesh_layout(x @ p["wq"], x @ p["wk"], x @ p["wv"], H, KV, seq_dim=None)
    q = _split_heads(q, H, hd)                    # (B,1,H,hd)
    k_new = _split_heads(k_new, KV, hd)
    v_new = _split_heads(v_new, KV, hd)
    posb = pos.expand(x.shape[0], 1)
    sin, cos = rope_freqs(posb, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)
    slot = torch.remainder(pos, S) if ring else torch.clamp(pos, 0, S - 1)
    step = functools.partial(_decode_step, groups=H // KV, hd=hd, window=window, ring=ring,
                             attn_softcap=cfg.attn_softcap, cache_len=S)
    out = _decode_per_shard(step, q, k_new, v_new, cache["k"], cache["v"], slot.long(), pos)
    return _reduced(_merge_heads(out) @ p["wo"]), {"k": cache["k"], "v": cache["v"]}


def _decode_step(q, k_new, v_new, k_cache, v_cache, slot, pos, *, groups: int, hd: int,
                 window: Optional[int], ring: bool, attn_softcap: Optional[float],
                 cache_len: int, reduce_hd=None, seq=None) -> torch.Tensor:
    """Write the new key and value at ``slot`` of the caches (in place),
    then attend: q (B, 1, H, hd') against caches (B, S', KV, hd').

    On a device's shard (:func:`_decode_per_shard`): ``reduce_hd`` sums
    the scores' partial products when ``hd'`` is a shard of head_dim;
    ``seq = (offset, reduce_max, reduce_sum)`` when the caches hold the
    positions ``offset .. offset + S'`` of a sequence split over devices:
    the write lands only where the slot is this shard's, and the softmax's
    max and sum and the weighted values are reduced over the shards
    (flash-decoding)."""
    S_l = k_cache.shape[1]
    if seq is None:
        at = slot.reshape(1)
        k_cache.index_copy_(1, at, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v_new.to(v_cache.dtype))
        idx = torch.arange(S_l, device=q.device)
    else:
        offset, reduce_max, reduce_sum = seq
        local = slot - offset
        inside = (local >= 0) & (local < S_l)
        at = torch.clamp(local, 0, S_l - 1).reshape(1)
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            cache.index_copy_(1, at, torch.where(inside, new.to(cache.dtype),
                                                  cache.index_select(1, at)))
        idx = offset + torch.arange(S_l, device=q.device)
    kr = _repeat_kv(k_cache, groups)
    vr = _repeat_kv(v_cache, groups)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr)
    if reduce_hd is not None:
        scores = reduce_hd(scores)
    scores = scores / np.sqrt(hd)  # (B,H,1,S)
    if attn_softcap:
        scores = softcap(scores, attn_softcap)
    if ring:
        k_pos = pos - torch.remainder(pos - idx, cache_len)   # absolute position held by slot
        valid = k_pos >= 0
    else:
        valid = idx <= pos
        if window is not None:
            valid &= idx > pos - window
    scores = torch.where(valid[None, None, None, :], scores, -1e9)
    if seq is None:
        w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, vr)
    sf = scores.float()
    m = reduce_max(torch.amax(sf, dim=-1, keepdim=True))
    e = torch.exp(sf - m)
    w = (e / reduce_sum(torch.sum(e, dim=-1, keepdim=True))).to(q.dtype)
    return reduce_sum(torch.einsum("bhqk,bkhd->bqhd", w, vr))


def _decode_per_shard(step, q, k_new, v_new, k_cache, v_cache, slot, pos) -> torch.Tensor:
    """``step(q, k_new, v_new, k_cache, v_cache, slot, pos)``.  Under a
    registered mesh with DTensor caches split over the model dim or over
    their sequence, each device writes and attends with its own shard
    (``local_map``): over KV heads its queries' heads are its own; over
    head_dim the scores are partial products, summed over the model dim
    (one all-reduce of (B, H, 1, S) a layer); over the sequence (the
    batch-1 long context on the data dim) the softmax's max and sum and
    the output are all-reduced over the data dim.  These collectives are
    written out here: DTensor's own ``einsum`` would flatten batch and
    heads into one dim split over two mesh dims, which its batched
    product cannot take, and it has no strategy that keeps a cache split
    by position."""
    from repro_torch.models.transformer import modules
    from torch.distributed.tensor import DTensor

    mesh = modules._LOGICAL_MESH
    if mesh is None or not isinstance(k_cache, DTensor):
        return step(q, k_new, v_new, k_cache, v_cache, slot, pos)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    pl = tuple(k_cache.placements)
    if not any(p in (Shard(1), Shard(2), Shard(3)) for p in pl):
        return step(q, k_new, v_new, k_cache, v_cache, slot, pos)
    kw = {}
    if "model" in names and pl[names.index("model")] == Shard(3):
        group = mesh.get_group("model")
        kw["reduce_hd"] = lambda t: funcol.all_reduce(t, "sum", group)  # noqa: E731
    seq_dims = [names[i] for i, p in enumerate(pl) if p == Shard(1)]
    if seq_dims:
        group = mesh.get_group(seq_dims[0])
        offset = mesh.get_local_rank(seq_dims[0]) * (k_cache.shape[1] // mesh.size(
            names.index(seq_dims[0])))
        kw["seq"] = (offset, lambda t: funcol.all_reduce(t, "max", group),
                     lambda t: funcol.all_reduce(t, "sum", group))
    q_pl = tuple(Replicate() if p == Shard(1) else p for p in pl)
    rep = tuple(Replicate() for _ in names)
    return local_map(functools.partial(step, **kw), out_placements=(q_pl,),
                     in_placements=(q_pl, q_pl, q_pl, pl, pl, rep, rep), device_mesh=mesh,
                     redistribute_inputs=True)(q, k_new, v_new, k_cache, v_cache, slot, pos)


def cross_attention(
    p: Mapping,
    cfg: ArchConfig,
    x: torch.Tensor,        # (B, S_dec, d)
    enc_out: torch.Tensor,  # (B, S_enc, d)
) -> torch.Tensor:
    """Whisper-style encoder-decoder cross attention (no mask, no RoPE)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _mesh_layout(x @ p["wq"], enc_out @ p["wk"], enc_out @ p["wv"], H, KV)
    q = _split_heads(q, H, hd)
    k = _repeat_kv(_split_heads(k, KV, hd), H // KV)
    v = _repeat_kv(_split_heads(v, KV, hd), H // KV)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return _reduced(_merge_heads(out) @ p["wo"])
