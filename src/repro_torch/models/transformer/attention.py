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

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.modules import apply_rope, rope_freqs, scaled_normal, softcap


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
    kf, vf = k.float(), v.float()
    acc = torch.zeros((B, S, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, S, H), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=dev)
    for j in range(nb):
        k_j, v_j = kf[:, j * blk:(j + 1) * blk], vf[:, j * blk:(j + 1) * blk]
        s = torch.einsum("bqhd,bkhd->bqhk", q, k_j) * scale  # (B,S,H,blk)
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
    q = _split_heads(x @ p["wq"], H, hd)
    k = _split_heads(x @ p["wk"], KV, hd)
    v = _split_heads(x @ p["wv"], KV, hd)
    sin, cos = rope_freqs(positions[None, :], hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    if window is not None and S > 2 * window and S % window == 0:
        out = _banded_local_attention(q, k, v, window, cfg.attn_softcap)
    else:
        out = _flash_attention(q, k, v, window, cfg.attn_softcap)
    return out.reshape(B, S, H * hd) @ p["wo"]


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
    q = _split_heads(x @ p["wq"], H, hd)          # (B,1,H,hd)
    k_new = _split_heads(x @ p["wk"], KV, hd)
    v_new = _split_heads(x @ p["wv"], KV, hd)
    posb = pos.expand(x.shape[0], 1)
    sin, cos = rope_freqs(posb, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)
    slot = torch.remainder(pos, S) if ring else torch.clamp(pos, 0, S - 1)
    slot = slot.reshape(1).long()
    k = cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    kr = _repeat_kv(k, H // KV)
    vr = _repeat_kv(v, H // KV)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(hd)  # (B,H,1,S)
    if cfg.attn_softcap:
        scores = softcap(scores, cfg.attn_softcap)
    idx = torch.arange(S, device=x.device)
    if ring:
        k_pos = pos - torch.remainder(pos - idx, S)   # absolute position held by slot
        valid = k_pos >= 0
    else:
        valid = idx <= pos
        if window is not None:
            valid &= idx > pos - window
    scores = torch.where(valid[None, None, None, :], scores, -1e9)
    w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vr)
    return out.reshape(*x.shape[:-1], H * hd) @ p["wo"], {"k": k, "v": v}


def cross_attention(
    p: Mapping,
    cfg: ArchConfig,
    x: torch.Tensor,        # (B, S_dec, d)
    enc_out: torch.Tensor,  # (B, S_enc, d)
) -> torch.Tensor:
    """Whisper-style encoder-decoder cross attention (no mask, no RoPE)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _split_heads(x @ p["wq"], H, hd)
    k = _repeat_kv(_split_heads(enc_out @ p["wk"], KV, hd), H // KV)
    v = _repeat_kv(_split_heads(enc_out @ p["wv"], KV, hd), H // KV)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return out.reshape(*x.shape[:-1], H * hd) @ p["wo"]
