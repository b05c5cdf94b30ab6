"""Shared transformer building blocks (port of
``repro.models.transformer.modules``).

The reference's ``shard_hint`` and ``set_logical_mesh`` have no
counterpart: with no registered mesh ``shard_hint`` returns its input
unchanged, and the port runs on one card, so the model code leaves those
calls out.
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import threefry


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (cap * torch.tanh(x / cap)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The inverse frequencies, computed in float64 as the reference's numpy
    does and rounded to float32, as JAX multiplies them; uploaded once a
    device (a pageable host-to-device copy in every step would make the
    host wait)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim // 2) * 2.0 / head_dim))
    with torch.inference_mode(False):  # a normal tensor, also for autograd callers
        return torch.as_tensor(inv.astype(np.float32), device=device)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions (...,) -> (sin, cos) of shape (..., head_dim/2)."""
    ang = positions[..., None].float() * _inv_freqs(head_dim, float(theta), positions.device)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., n_heads, head_dim); sin/cos broadcastable (..., head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]  # add head axis
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),  # nemotron squared-ReLU
}


def mlp_apply(p: Mapping, x: torch.Tensor, activation: str, gated: bool) -> torch.Tensor:
    act = _ACTS[activation]
    if gated:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    return h @ p["w_down"]


def scaled_normal(key: torch.Tensor, shape, scale: float, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32) * scale``, the product in
    float32 as JAX's weakly typed scalar gives it."""
    return threefry.normal(key, shape, device=device) * float(np.float32(scale))


def init_mlp(key: torch.Tensor, d_model: int, d_ff: int, gated: bool,
             device: Optional[torch.device] = None) -> dict:
    k1, k2, k3 = threefry.split(key, 3)
    s_in = float(1.0 / np.sqrt(d_model))
    s_out = float(1.0 / np.sqrt(d_ff))
    p = {
        "w_up": scaled_normal(k1, (d_model, d_ff), s_in, device),
        "w_down": scaled_normal(k2, (d_ff, d_model), s_out, device),
    }
    if gated:
        p["w_gate"] = scaled_normal(k3, (d_model, d_ff), s_in, device)
    return p


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """(..., Q, K) boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m
