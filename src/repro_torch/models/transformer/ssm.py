"""Mamba-2 SSD (state-space duality) sequence mixer [arXiv:2405.21060];
port of ``repro.models.transformer.ssm``.

Chunked matmul formulation: within-chunk terms are dense masked
matmuls; the cross-chunk recurrence is a loop carrying the (B, H, P, N)
state.  Single B/C group shared across heads (Mamba-2 default
ngroups=1).

Decode is the O(1) recurrent step:  h <- exp(dt·A) h + (dt·x) ⊗ B;
y = C·h + D·x, with a rolling causal-conv state.
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import threefry
from repro_torch.core.rng import _log
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.modules import model_dim, scaled_normal, shard_hint


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no linear cut-off
    (``F.softplus`` returns ``x`` itself above ``threshold=20``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_ssm(key: torch.Tensor, cfg: ArchConfig, device: Optional[torch.device] = None) -> dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = di // H
    assert H * P == di, (di, H)
    ks = threefry.split(key, 5)
    s = float(1.0 / np.sqrt(d))
    conv_dim = di + 2 * N
    return {
        # fused input projection: [z (di) | x (di) | B (N) | C (N) | dt (H)]
        "w_in": scaled_normal(ks[0], (d, 2 * di + 2 * N + H), s, device),
        "conv_w": scaled_normal(ks[1], (cfg.ssm_conv, conv_dim), 0.1, device),
        # jnp.log of a float32 uniform: XLA's float32 log, bit for bit
        "A_log": _log(threefry.uniform(ks[2], (H,), 1.0, 16.0)).to(device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "w_out": scaled_normal(ks[3], (di, d), float(1.0 / np.sqrt(di)), device),
    }


def _split_in(p: Mapping, cfg: ArchConfig, u: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    # under a registered mesh the fused projection's columns come back whole
    # on every model rank (its z | x | B | C | dt split does not follow the
    # column shards); the identity otherwise
    zxbcdt = shard_hint(u @ p["w_in"], "batch", None, None)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * N:]
    return z, xbc, dt_raw


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, C) depthwise causal conv, kernel (K, C)."""
    K = w.shape[0]
    # F.pad's values by concatenation (a DTensor's pad fails to redistribute
    # in some torch releases)
    pad = torch.cat([torch.zeros_like(xbc[:, :1]).repeat(1, K - 1, 1), xbc], dim=1)
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(K))
    return F.silu(out)


def ssm_train(p: Mapping, cfg: ArchConfig, u: torch.Tensor) -> torch.Tensor:
    """(B, S, d_model) -> (B, S, d_model); chunked SSD scan."""
    B, S, _ = u.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = di // H

    z, xbc, dt_raw = _split_in(p, cfg, u)
    xbc = _causal_conv(xbc, p["conv_w"])
    # under a registered mesh (the dry-run) the conv's channels come back
    # whole on every model rank (an all-gather), so x, B and C slice locally
    xbc = shard_hint(xbc, "batch", None, None)
    x = xbc[..., :di].reshape(B, S, H, P)
    Bm = xbc[..., di:di + N]                       # (B,S,N)
    Cm = xbc[..., di + N:]                         # (B,S,N)
    scan = functools.partial(_ssd_scan, chunk=min(cfg.ssm_chunk, S))
    y = _per_ssm_head(scan, x, dt_raw, Bm, Cm, p["dt_bias"], p["A_log"], p["D"])
    # split over the model dim into the row-parallel out-projection (its
    # gradient arrives so split; the identity without a mesh)
    y = shard_hint(y.reshape(B, S, di), "batch", None, "model").to(u.dtype)
    return (y * F.silu(z)) @ p["w_out"]


def _ssd_scan(x, dt_raw, Bm, Cm, dt_bias, A_log, D, *, chunk: int) -> torch.Tensor:
    """The chunked SSD of x (B, S, H, P) -> y (B, S, H, P) float32, each
    head on its own (B and C shared across heads)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    assert S % Q == 0, (S, Q)
    nc = S // Q
    dt = softplus(dt_raw.float() + dt_bias)        # (B,S,H)
    A = -torch.exp(A_log)                          # (H,) negative

    la = dt * A                                    # (B,S,H) log decay
    xb = x.float() * dt[..., None]                 # dt-scaled input

    # chunk views
    la_c = la.reshape(B, nc, Q, H)
    cum = torch.cumsum(la_c, dim=2)                # (B,nc,Q,H)
    xb_c = xb.reshape(B, nc, Q, H, P)
    B_c = Bm.reshape(B, nc, Q, N).float()
    C_c = Cm.reshape(B, nc, Q, N).float()

    # ---- intra-chunk (dense masked matmuls) ----
    G = torch.einsum("bcin,bcjn->bcij", C_c, B_c)  # (B,nc,Q,Q)
    # the exponent clamped at 0: exact on the causal (i >= j) region
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    decay = torch.exp(torch.clamp(diff, max=0.0))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = G[..., None] * torch.where(mask[None, None, :, :, None], decay, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xb_c)

    # ---- chunk summaries + cross-chunk recurrence ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,H)
    S_c = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end, B_c, xb_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    in_decay = torch.exp(cum)                                  # decay start->i

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    y_inter = []
    for c in range(nc):
        # contribution of the carried state to every position in the chunk
        y_inter.append(torch.einsum("bin,bhpn,bih->bihp", C_c[:, c], h, in_decay[:, c]))
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    y_inter = torch.stack(y_inter, dim=1)  # (B,nc,Q,H,P)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y + D[None, None, :, None] * x.float()


def _per_ssm_head(scan, x, dt_raw, Bm, Cm, dt_bias, A_log, D) -> torch.Tensor:
    """``scan(...)``.  Under a registered mesh with DTensors, each device
    scans its own heads (``local_map``: x, dt and the per-head parameters
    split over the model dim where the heads divide it, B and C whole);
    DTensor's own ``einsum`` would flatten batch and heads into one dim
    split over two mesh dims, which its batched product cannot take."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    md = model_dim()
    if md is None or not isinstance(x, DTensor):
        return scan(x, dt_raw, Bm, Cm, dt_bias, A_log, D)
    mesh, mi = md
    H = x.shape[2]
    split = H % mesh.shape[mi] == 0

    def on_model(t, pl):
        pls = [Replicate() if i == mi else p for i, p in enumerate(t.placements)]
        pls[mi] = pl
        return tuple(pls)

    head = lambda t, d: on_model(t, Shard(d) if split else Replicate())  # noqa: E731
    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    return local_map(scan, out_placements=(head(x, 2),),
                     in_placements=(head(x, 2), head(dt_raw, 2), on_model(Bm, Replicate()),
                                    on_model(Cm, Replicate()), head(dt_bias, 0) if split else rep,
                                    head(A_log, 0) if split else rep,
                                    head(D, 0) if split else rep),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, dt_raw, Bm, Cm, dt_bias, A_log, D)


def init_ssm_state(cfg: ArchConfig, batch: int, device: Optional[torch.device] = None) -> dict:
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = di // H
    conv_dim = di + 2 * N
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=cfg.torch_dtype,
                            device=device),
    }


def ssm_decode(p: Mapping, cfg: ArchConfig, u: torch.Tensor, state: dict):
    """One-token step: u (B, 1, d) -> (y (B, 1, d), new state)."""
    B = u.shape[0]
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = di // H
    z, xbc, dt_raw = _split_in(p, cfg, u)
    z, xbc, dt_raw = z[:, 0], xbc[:, 0], dt_raw[:, 0]

    # rolling causal conv
    hist = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"])
    xbc = F.silu(conv_out)
    new_conv = hist[:, 1:, :]

    x = xbc[..., :di].reshape(B, H, P).float()
    Bm = xbc[..., di:di + N].float()
    Cm = xbc[..., di + N:].float()
    dt = softplus(dt_raw.float() + p["dt_bias"])                  # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                     # (B,H)
    xdt = x * dt[..., None]                                       # (B,H,P)
    h = state["h"] * decay[:, :, None, None] + torch.einsum("bhp,bn->bhpn", xdt, Bm)
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + p["D"][None, :, None] * x
    y = y.reshape(B, 1, di).to(u.dtype)
    out = (y * F.silu(z[:, None, :])) @ p["w_out"]
    return out, {"h": h, "conv": new_conv}
