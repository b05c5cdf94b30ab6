"""GNN models over padded bipartite layer blocks (port of ``repro.models.gnn``).

Every layer consumes ``H~`` -- embeddings indexed by the next frontier
``S^{l+1}`` -- plus the layer's local indices (``self_idx``, ``nbr_idx``,
``mask``), and emits embeddings for the layer's destination frontier
``S^l``.  Plan layer ``L-1`` consumes raw features, layer 0 emits class
logits.

Models: gcn | sage | gat | rgcn, as in the JAX package (the paper
evaluates GCN, R-GCN and GAT, §4.3).  Parameters keep the JAX package's
names and layouts (``(d_in, d_out)`` weights, R-GCN's ``(R, d_in, d_out)``
relation weights) so :func:`params_from_jax` copies them over unchanged.
On a CUDA device the GCN's neighbor sum goes through the ``spmm`` kernel,
the GraphSAGE and R-GCN neighbor means through its mean mode, and the
GAT's attention softmax through the ``seg_softmax`` kernel (each with its
backward kernel); the JAX layers compute the same functions in plain jnp.

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
import torch.nn.functional as F
from torch import nn

from repro_torch.core import threefry
from repro_torch.core.frontier import take_rows
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.seg_softmax import seg_softmax
from repro_torch.kernels.spmm import spmm_mean, spmm_sum

MODELS = ("gcn", "sage", "gat", "rgcn")


def _check_model(cfg) -> None:
    if cfg.model not in MODELS:
        raise ValueError(f"unknown gnn model {cfg.model!r}; expected one of {MODELS}")


@dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"           # gcn | sage | gat | rgcn
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


def _params(dtype, device):
    return lambda *shape: nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class GCNLayer(nn.Module):
    """Mean over {self} ∪ N(s), then ``x @ w + b`` (ReLU except on layer 0).

    Every layer takes ``(Ht, self_idx, nbr_idx, mask, etypes)``; only the
    R-GCN reads ``etypes``."""

    def __init__(self, d_in: int, d_out: int, relu: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        zeros = _params(dtype, device)
        self.w, self.b = zeros(d_in, d_out), zeros(d_out)
        self.relu = relu

    def forward(self, Ht, self_idx, nbr_idx, mask, etypes=None):
        h_self = take_rows(Ht, self_idx)            # (n, d_in)
        deg = mask.sum(dim=-1, keepdim=True) + 1
        agg = (spmm_sum(Ht, nbr_idx, mask) + h_self) / deg
        out = agg @ self.w + self.b
        return torch.relu(out) if self.relu else out


class SAGELayer(nn.Module):
    """GraphSAGE: ``h_self @ w_self + mean_nbr @ w_nbr + b`` (ReLU except on
    layer 0), the neighbor mean over the masked slots, divided by
    ``max(deg, 1)``."""

    def __init__(self, d_in: int, d_out: int, relu: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        zeros = _params(dtype, device)
        self.w_self, self.w_nbr, self.b = zeros(d_in, d_out), zeros(d_in, d_out), zeros(d_out)
        self.relu = relu

    def forward(self, Ht, self_idx, nbr_idx, mask, etypes=None):
        out = take_rows(Ht, self_idx) @ self.w_self + spmm_mean(Ht, nbr_idx, mask) @ self.w_nbr
        out = out + self.b
        return torch.relu(out) if self.relu else out


class RGCNLayer(nn.Module):
    """R-GCN: ``h_self @ w_self``, then ``+ mean_r @ w_rel[r]`` for every
    relation ``r`` in order, then ``+ b`` (ReLU except on layer 0), as
    ``layer_apply``'s ``rgcn`` branch adds them.  ``mean_r`` is the
    neighbor mean over the slots of relation ``r`` (all slots are relation 0
    when the plan carries no ``etypes``): one ``spmm`` mean a relation."""

    def __init__(self, d_in: int, d_out: int, num_relations: int, relu: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        zeros = _params(dtype, device)
        self.w_self = zeros(d_in, d_out)
        self.w_rel = zeros(num_relations, d_in, d_out)
        self.b = zeros(d_out)
        self.relu = relu

    def forward(self, Ht, self_idx, nbr_idx, mask, etypes=None):
        out = take_rows(Ht, self_idx) @ self.w_self
        if etypes is None:
            etypes = torch.zeros_like(nbr_idx)
        for r in range(self.w_rel.shape[0]):
            out = out + spmm_mean(Ht, nbr_idx, mask & (etypes == r)) @ self.w_rel[r]
        out = out + self.b
        return torch.relu(out) if self.relu else out


class GATLayer(nn.Module):
    """Multi-head graph attention over {self} and the sampled neighbors.

    Per head: ``z = x @ w``, logits ``leaky_relu(a_src·z_nbr + a_dst·z_self,
    0.2)``, ``alpha`` their masked softmax over the neighbor slots,
    ``agg = sum_w alpha · z_nbr``; then ``(agg + z_self) @ w_out + b``, heads
    concatenated (ReLU except on layer 0), as ``layer_apply``'s ``gat``
    branch computes.  ``Ht`` is projected once over its rows and rows of
    the product are gathered, where the JAX layer gathers ``Ht`` and
    projects every slot: row for row the same function, fewer operations.
    """

    def __init__(self, d_in: int, d_out: int, heads: int, relu: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        dh = max(1, d_out // heads)
        zeros = _params(dtype, device)
        self.w = zeros(d_in, heads * dh)
        self.a_src = zeros(heads, dh)
        self.a_dst = zeros(heads, dh)
        self.w_out = zeros(heads * dh, d_out)
        self.b = zeros(d_out)
        self.heads, self.relu = heads, relu

    def forward(self, Ht, self_idx, nbr_idx, mask, etypes=None):
        h, (n, w) = self.heads, nbr_idx.shape
        z = Ht @ self.w                                               # (S, h*dh)
        src_logit = torch.einsum("shd,hd->sh", z.reshape(z.shape[0], h, -1), self.a_src)
        z_self = take_rows(z, self_idx)                               # (n, h*dh)
        e_dst = torch.einsum("nhd,hd->nh", z_self.reshape(n, h, -1), self.a_dst)
        e = F.leaky_relu(take_rows(src_logit, nbr_idx) + e_dst[:, None, :], 0.2)
        alpha = seg_softmax(e, mask)                                  # (n, w, h)
        z_nbr = take_rows(z, nbr_idx).reshape(n, w, h, -1)            # (n, w, h, dh)
        agg = torch.einsum("nwh,nwhd->nhd", alpha, z_nbr).reshape(n, -1)
        out = (agg + z_self) @ self.w_out + self.b
        return torch.relu(out) if self.relu else out


class GNN(nn.Module):
    """``layers[l]`` is plan layer ``l`` (layer 0 emits logits)."""

    def __init__(self, cfg: GNNConfig, device: DeviceLike = None):
        super().__init__()
        _check_model(cfg)
        dev = resolve_device(device)
        self.cfg = cfg

        def layer(l):
            kw = dict(relu=l != 0, dtype=cfg.dtype, device=dev)
            if cfg.model == "gat":
                return GATLayer(*cfg.dims(l), cfg.num_heads, **kw)
            if cfg.model == "rgcn":
                return RGCNLayer(*cfg.dims(l), cfg.num_relations, **kw)
            if cfg.model == "sage":
                return SAGELayer(*cfg.dims(l), **kw)
            return GCNLayer(*cfg.dims(l), **kw)

        self.layers = nn.ModuleList(layer(l) for l in range(cfg.num_layers))

    def forward(self, plan_layers, H_input: torch.Tensor) -> torch.Tensor:
        """Seed logits (cap_0, C) from input embeddings over an L-layer plan."""
        H = H_input
        for l in reversed(range(self.cfg.num_layers)):
            blk = plan_layers[l]
            H = self.layers[l](H, blk.self_idx, blk.nbr_idx, blk.mask, blk.etypes)
        return H


def init_gnn(cfg: GNNConfig, seed: int = 0, device: DeviceLike = None) -> GNN:
    """``repro.models.gnn.init_gnn(jax.random.PRNGKey(seed), cfg)``'s weights,
    bit for bit: Glorot-uniform weights and zero biases, drawn on the CPU
    with the port of ``jax.random`` (:mod:`repro_torch.core.threefry`) in
    the JAX package's order, then moved to ``device``."""
    _check_model(cfg)
    key = threefry.prng_key(seed)
    layers = []
    for l in range(cfg.num_layers):
        keys = threefry.split(key, 6)
        key, ks = keys[0], keys[1:]
        d_in, d_out = cfg.dims(l)
        if cfg.model == "gcn":
            shapes = {"w": (d_in, d_out)}
        elif cfg.model == "sage":
            shapes = {"w_self": (d_in, d_out), "w_nbr": (d_in, d_out)}
        elif cfg.model == "rgcn":
            shapes = {"w_self": (d_in, d_out), "w_rel": (cfg.num_relations, d_in, d_out)}
        else:
            h = cfg.num_heads
            dh = max(1, d_out // h)
            # a_src / a_dst are drawn as (h, dh, 1), then squeezed
            shapes = {"w": (d_in, h * dh), "a_src": (h, dh, 1), "a_dst": (h, dh, 1),
                      "w_out": (h * dh, d_out)}
        p = {}
        for k, (name, shape) in zip(ks, shapes.items()):
            # Glorot: fan in and out are the last two axes
            lim = float(np.sqrt(6.0 / (shape[-2] + shape[-1])))
            w = threefry.uniform(k, shape, -lim, lim)
            p[name] = (w[..., 0] if name.startswith("a_") else w).numpy()
        p["b"] = np.zeros((d_out,), np.float32)
        layers.append(p)
    return params_from_jax({"layers": layers}, cfg, device=device)


def params_from_jax(params_np: dict, cfg: GNNConfig, device: DeviceLike = None) -> GNN:
    """A :class:`GNN` holding ``repro.models.gnn.init_gnn``'s parameters.

    ``params_np`` is that pytree with numpy leaves, one dict per layer with
    the JAX names and shapes: ``{"w": (d_in, d_out), "b": (d_out,)}`` for
    the GCN; ``w_self`` and ``w_nbr`` (d_in, d_out) and ``b`` for GraphSAGE;
    ``w`` (d_in, h*dh), ``a_src`` and ``a_dst`` (h, dh), ``w_out``
    (h*dh, d_out) and ``b`` for the GAT; ``w_self`` (d_in, d_out), ``w_rel``
    (R, d_in, d_out) and ``b`` for R-GCN.  Any numpy weights in that layout
    work the same way.
    """
    model = GNN(cfg, device=device)
    if len(params_np["layers"]) != cfg.num_layers:
        raise ValueError(
            f"{len(params_np['layers'])} parameter layers for "
            f"num_layers={cfg.num_layers}"
        )
    with torch.no_grad():
        for l, (layer, p) in enumerate(zip(model.layers, params_np["layers"])):
            names = dict(layer.named_parameters())
            if set(p) != set(names):
                raise ValueError(f"layer {l}: parameters {sorted(p)}, want {sorted(names)}")
            for name, dst in names.items():
                src = torch.from_numpy(np.array(p[name], dtype=np.float32))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"layer {l} {name}: shape {tuple(src.shape)} != {tuple(dst.shape)}"
                    )
                dst.copy_(src)
    return model


def gnn_apply(model: GNN, cfg: GNNConfig, plan_layers, H_input: torch.Tensor) -> torch.Tensor:
    """Forward pass over an L-layer plan; returns seed logits (cap_0, C)."""
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
    bipartite layer compute is per PE and goes through ``ex.pe``, with
    the block's relation ids where the plan has them.
    """
    from repro_torch.core.cooperative import redistribute

    H = H_input
    for l in reversed(range(cfg.num_layers)):
        blk = plan_layers[l]
        Ht = redistribute(ex, blk, H, tilde_caps[l], l)
        args = (Ht, blk.self_idx, blk.nbr_idx, blk.mask)
        H = ex.pe(model.layers[l], *args, *(() if blk.etypes is None else (blk.etypes,)))
    return H
