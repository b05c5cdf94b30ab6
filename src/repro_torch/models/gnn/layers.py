"""GNN models over padded bipartite layer blocks (port of ``repro.models.gnn``).

Every layer consumes ``H~`` -- embeddings indexed by the next frontier
``S^{l+1}`` -- plus the layer's local indices (``self_idx``, ``nbr_idx``,
``mask``), and emits embeddings for the layer's destination frontier
``S^l``.  Plan layer ``L-1`` consumes raw features, layer 0 emits class
logits.

Ported: the GCN.  Weights keep the JAX package's ``(d_in, d_out)`` layout
so :func:`params_from_jax` copies them over unchanged.  The neighbor sum
goes through the ``spmm`` kernel (with its backward kernel) on a CUDA
device; the JAX layer computes the same function in plain jnp.

Three applies, as in the JAX package: :func:`gnn_apply` (one plan),
:func:`gnn_apply_stacked` (``P`` stacked independent plans, one apply per
PE) and :func:`gnn_apply_cooperative` (a ``redistribute`` before each
layer, then one apply per PE).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.core.frontier import take_rows
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.spmm import spmm_sum

_MODEL_TODO = (
    "only the GCN is ported to repro_torch yet (ROADMAP.md queue A, item A9)"
)


@dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"           # gcn (sage | gat | rgcn not ported yet)
    num_layers: int = 3
    in_dim: int = 64
    hidden_dim: int = 256
    num_classes: int = 16
    num_heads: int = 4           # gat
    num_relations: int = 1       # rgcn
    dtype: torch.dtype = torch.float32

    def dims(self, l: int) -> tuple[int, int]:
        """(d_in, d_out) of plan layer ``l``."""
        d_in = self.in_dim if l == self.num_layers - 1 else self.hidden_dim
        d_out = self.num_classes if l == 0 else self.hidden_dim
        return d_in, d_out


class GCNLayer(nn.Module):
    """Mean over {self} ∪ N(s), then ``x @ w + b`` (ReLU except on layer 0)."""

    def __init__(self, d_in: int, d_out: int, relu: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d_in, d_out), dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype, device=device))
        self.relu = relu

    def forward(self, Ht, self_idx, nbr_idx, mask):
        h_self = take_rows(Ht, self_idx)            # (n, d_in)
        deg = mask.sum(dim=-1, keepdim=True) + 1
        agg = (spmm_sum(Ht, nbr_idx, mask) + h_self) / deg
        out = agg @ self.w + self.b
        return torch.relu(out) if self.relu else out


class GNN(nn.Module):
    """``layers[l]`` is plan layer ``l`` (layer 0 emits logits)."""

    def __init__(self, cfg: GNNConfig, device: DeviceLike = None):
        super().__init__()
        if cfg.model != "gcn":
            raise NotImplementedError(_MODEL_TODO)
        dev = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            GCNLayer(*cfg.dims(l), relu=l != 0, dtype=cfg.dtype, device=dev)
            for l in range(cfg.num_layers)
        )

    def forward(self, plan_layers, H_input: torch.Tensor) -> torch.Tensor:
        """Seed logits (cap_0, C) from input embeddings over an L-layer plan."""
        H = H_input
        for l in reversed(range(self.cfg.num_layers)):
            blk = plan_layers[l]
            H = self.layers[l](H, blk.self_idx, blk.nbr_idx, blk.mask)
        return H


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device: DeviceLike = None) -> GNN:
    """Glorot-uniform weights and zero biases, drawn from ``generator``."""
    model = GNN(cfg, device=device)
    with torch.no_grad():
        for layer in model.layers:
            d_in, d_out = layer.w.shape
            lim = float(np.sqrt(6.0 / (d_in + d_out)))
            w = torch.rand((d_in, d_out), generator=generator, dtype=cfg.dtype)
            layer.w.copy_(w * (2 * lim) - lim)
    return model


def params_from_jax(params_np: dict, cfg: GNNConfig, device: DeviceLike = None) -> GNN:
    """A :class:`GNN` holding ``repro.models.gnn.init_gnn``'s parameters.

    ``params_np`` is that pytree with numpy leaves:
    ``{"layers": [{"w": (d_in, d_out), "b": (d_out,)}, ...]}``.  Any numpy
    weights in that layout work the same way.
    """
    model = GNN(cfg, device=device)
    if len(params_np["layers"]) != cfg.num_layers:
        raise ValueError(
            f"{len(params_np['layers'])} parameter layers for "
            f"num_layers={cfg.num_layers}"
        )
    with torch.no_grad():
        for layer, p in zip(model.layers, params_np["layers"]):
            for name in ("w", "b"):
                src = torch.from_numpy(np.array(p[name], dtype=np.float32))
                dst = getattr(layer, name)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"{name}: shape {tuple(src.shape)} != {tuple(dst.shape)}"
                    )
                dst.copy_(src)
    return model


def gnn_apply(model: GNN, cfg: GNNConfig, plan_layers, H_input: torch.Tensor) -> torch.Tensor:
    """Forward pass over an L-layer plan; returns seed logits (cap_0, C)."""
    if cfg.model != "gcn":
        raise NotImplementedError(_MODEL_TODO)
    return model(plan_layers, H_input)


def _pe_slice(blk, p: int):
    """PE ``p``'s block of a stacked plan layer."""
    return dataclasses.replace(blk, **{
        f.name: getattr(blk, f.name)[p] for f in dataclasses.fields(blk)
        if getattr(blk, f.name) is not None
    })


def gnn_apply_stacked(model: GNN, cfg: GNNConfig, plan_layers, H_input: torch.Tensor) -> torch.Tensor:
    """``P`` stacked independent plans (leaves ``(P, ...)``): one apply per
    PE, logits stacked to ``(P, cap_0, C)``."""
    return torch.stack([
        gnn_apply(model, cfg, [_pe_slice(blk, p) for blk in plan_layers], H_input[p])
        for p in range(H_input.shape[0])
    ])


def gnn_apply_cooperative(
    model: GNN,
    cfg: GNNConfig,
    ex,                     # cooperative.Executor
    plan_layers,            # CoopLayer blocks
    H_input: torch.Tensor,  # per-PE owned input embeddings (P, cap_L, d)
    tilde_caps,             # S~ capacities per layer
) -> torch.Tensor:
    """Cooperative forward (Alg. 1): redistribute, then per-PE compute.

    The redistribution is a global exchange (all PEs take part); the
    bipartite layer compute is per PE and goes through ``ex.pe``.
    """
    from repro_torch.core.cooperative import redistribute

    if cfg.model != "gcn":
        raise NotImplementedError(_MODEL_TODO)
    H = H_input
    for l in reversed(range(cfg.num_layers)):
        blk = plan_layers[l]
        Ht = redistribute(ex, blk, H, tilde_caps[l])
        H = ex.pe(model.layers[l], Ht, blk.self_idx, blk.nbr_idx, blk.mask)
    return H
