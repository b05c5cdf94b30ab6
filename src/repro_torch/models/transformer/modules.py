"""Shared transformer building blocks (port of
``repro.models.transformer.modules``).

Logical sharding hints: model code never imports mesh objects; a
launcher (the dry-run, ``repro_torch.launch.dryrun``) registers a
``DeviceMesh`` with :func:`set_logical_mesh`, and the model calls
``shard_hint(x, "batch", None, ...)`` where the reference constrains
GSPMD, so a DTensor keeps its batch dim sharded through reshapes (MoE
groups, the residual stream).  With no registered mesh (every real run
of the port) the hints return their input.
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import threefry


_LOGICAL_MESH = None


def set_logical_mesh(mesh) -> None:
    """Register (or clear, with None) the mesh used by :func:`shard_hint`."""
    global _LOGICAL_MESH
    _LOGICAL_MESH = mesh


def model_dim():
    """``(mesh, index of its "model" dim)`` when a registered mesh has one,
    else None (every real run of the port)."""
    mesh = _LOGICAL_MESH
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    return mesh, mesh.mesh_dim_names.index("model")


def on_mesh_dim(t, mesh, i: int, placement):
    """DTensor ``t`` redistributed to ``placement`` on mesh dim ``i``."""
    placements = list(t.placements)
    placements[i] = placement
    return t.redistribute(mesh, tuple(placements))


def shard_hint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute DTensor ``x`` to (batch|expert|model|seq|None, ...)
    over the registered mesh: ``batch`` over (``pod``,) ``data``,
    ``expert`` over ``data``, ``model`` and ``seq`` over ``model``, each
    only where the dim divides; every other mesh dim replicated.  A plain
    tensor, or any tensor with no mesh registered, comes back as it is."""
    mesh = _LOGICAL_MESH
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    names = mesh.mesh_dim_names
    size = dict(zip(names, mesh.shape))
    batch = tuple(a for a in ("pod", "data") if a in names)
    placements = [Replicate()] * len(names)

    def shard(axis: str, dim: int) -> None:
        if size[axis] > 1:  # one device's shard is the whole
            placements[names.index(axis)] = Shard(dim)

    for dim, (n, ax) in enumerate(zip(x.shape, logical)):
        if ax == "batch" and batch:
            if n % int(np.prod([size[a] for a in batch])) == 0 and n > 1:
                for a in batch:
                    shard(a, dim)
        elif ax == "expert" and "data" in names:
            # expert-parallel activations: the expert dim of dispatched
            # token blocks lives on the data dim
            if n % size["data"] == 0:
                shard("data", dim)
        elif ax in ("model", "seq") and "model" in names:
            # "seq": sequence parallelism of the residual stream
            if n % size["model"] == 0:
                shard("model", dim)
    placements = tuple(placements)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    # the constraint holds for the gradient too, as a sharding constraint's
    # transpose does in JAX: a partial gradient is reduced here, not carried
    # into the products before it
    return DTensor.from_local(x.to_local(grad_placements=placements), mesh, placements,
                              run_check=False, shape=x.shape, stride=x.stride())


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
    return _reduced(h @ p["w_down"])


def _reduced(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's output, summed over the model dim here
    (Megatron's all-reduce) under a registered mesh, batch-sharded.  Left
    partial, DTensor's cheapest backward all-gathers the weight instead
    and repeats the gradient's product on every model rank."""
    return shard_hint(y, "batch", *([None] * (y.ndim - 1)))


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
