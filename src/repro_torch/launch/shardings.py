"""Sharding rules for the architecture pool as DTensor placements; port of
``repro.launch.shardings``.

Megatron-style tensor parallelism on the ``model`` mesh dim, batch data
parallelism on (``pod``,) ``data``; divisibility-gated: a dim is only
sharded if it divides evenly by the mesh dims' size, otherwise
replicated (whisper-tiny's 6 heads on a 16-way model dim replicate, its
d_ff shards).  DTensor's uneven ``Shard`` is never used.  Optimizer
moments additionally shard their first replicated dim over the batch
dims (ZeRO-1) so grok-1-scale state fits.

A *spec* here is the reference's ``PartitionSpec`` as a tuple, one entry
a tensor dim: ``None``, a mesh dim name, or a tuple of names (a dim
sharded over ``("pod", "data")``).  :func:`to_placements` turns it into
one ``Placement`` a mesh dim: a dim sharded over two mesh dims is a
``Shard`` on both, the outer mesh dim major, as JAX tiles it.

The rules address *trailing* dims and are written for the reference's
layout, where each pattern slot's layers are stacked over a leading unit
axis U (``blocks/<slot>/...``) and leftover layers sit in ``tail/<i>``
unstacked.  The port holds one :class:`~repro_torch.models.transformer.
model.Block` a layer; :func:`reference_layout` maps each of its
parameters to the reference's path and (stacked) shape, the names
``lm_params_to_jax`` uses.  :func:`param_shardings` and
:func:`opt_shardings` apply the rule there and drop the unit axis.  A
parameter never shards U.  A moment may (ZeRO-1 takes the first free
dim, which is U when U divides by the batch dims): a layer of the port
has no U, so its moment shards its own first free dim over the batch
dims instead, the same bytes a device where that dim divides
(:func:`opt_shardings`).

``mesh`` is a ``DeviceMesh``, or anything with ``mesh_dim_names`` and a
``shape`` tuple (:class:`MeshShape`: the rules need no process group).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import batch_axes


class MeshShape(NamedTuple):
    """A mesh's dim names and sizes, without devices or a process group."""

    mesh_dim_names: tuple
    shape: tuple


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(name, tuple):
        return math.prod(sizes[a] for a in name)
    return sizes[name]


def _fit(mesh, shape: tuple, spec: tuple) -> tuple:
    """Drop sharding on dims that do not divide evenly."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax and dim % _axis_size(mesh, ax) == 0 else None
                 for dim, ax in zip(shape, spec))


def _param_spec(path: str, shape: tuple, mesh, moe_fsdp: bool = False) -> tuple:
    """Sharding rule for a parameter tensor by name, in the reference's
    layout (leading unit axis U on every stacked block parameter; leading
    dims are padded with None)."""
    leaf = path.split("/")[-1]
    nd = len(shape)
    dsz = _sizes(mesh).get("data", 1)

    def trailing(*axes) -> tuple:
        return (None,) * (nd - len(axes)) + axes

    if leaf == "embed":
        return ("model", None)           # (V, d): shard vocab
    if leaf == "unembed":
        return (None, "model")
    if nd >= 4 and leaf in ("w_up", "w_gate", "w_down"):
        # MoE expert weights (U, E, d, f) / (U, E, f, d): tensor-parallel
        # on the ff dim plus either expert-parallel (E % data == 0) or
        # FSDP on the other matmul dim.
        E = shape[-3]
        tp = ("model", None) if leaf == "w_down" else (None, "model")
        if E % dsz == 0 and not moe_fsdp:
            return (None,) * (nd - 3) + ("data", *tp)
        fsdp = (tp[0], "data") if tp[0] == "model" else ("data", tp[1])
        return (None,) * (nd - 3) + (None, *fsdp)
    if leaf in ("wq", "wk", "wv", "w_up", "w_gate", "w_in", "conv_w"):
        return trailing(None, "model")   # column parallel
    if leaf in ("wo", "w_down", "w_out"):
        return trailing("model", None)   # row parallel
    if leaf in ("A_log", "D", "dt_bias") and shape[-1] > 1:
        return trailing("model")         # SSD heads
    if leaf == "router":
        return trailing(None, None)
    return (None,) * nd                  # norms, biases: replicated


def param_spec(mesh, path: str, shape: tuple, moe_fsdp: bool = False) -> tuple:
    """The reference's parameter ``NamedSharding`` spec of ``path``."""
    return _fit(mesh, shape, _param_spec(path, shape, mesh, moe_fsdp))


def opt_spec(mesh, path: str, shape: tuple) -> tuple:
    """ZeRO-1: a moment shards the first unsharded dim over the batch dims
    (the reference's ``opt_shardings`` leaf)."""
    b_axes = batch_axes(mesh)
    spec = list(_fit(mesh, shape, _param_spec(path, shape, mesh)))
    used = {a for ax in spec if ax for a in (ax if isinstance(ax, tuple) else (ax,))}
    if not (set(b_axes) & used):
        for i, (dim, ax) in enumerate(zip(shape, spec)):
            if ax is None and dim % _axis_size(mesh, b_axes) == 0 and dim > 1:
                spec[i] = b_axes
                break
    return tuple(spec)


def data_spec(mesh, shape: tuple, batch_dim: int = 0) -> tuple:
    """Batch-sharded activation spec; falls back to replication."""
    b_axes = batch_axes(mesh)
    spec = [None] * len(shape)
    if shape[batch_dim] % _axis_size(mesh, b_axes) == 0:
        spec[batch_dim] = b_axes
    return tuple(spec)


def decode_state_spec(mesh, path: str, shape: tuple) -> tuple:
    """KV/SSM cache spec of one decode-state leaf.

    The batch dim shards over the batch dims when divisible; otherwise
    (the long-context batch=1 shape) KV caches shard their *sequence* dim
    over ``data``."""
    if shape == ():
        return ()
    b_axes = batch_axes(mesh)
    sizes = _sizes(mesh)
    spec = [None] * len(shape)
    leaf = path.split("/")[-1]
    msz = sizes.get("model", 1)
    if shape[0] % _axis_size(mesh, b_axes) == 0 and shape[0] > 1:
        spec[0] = b_axes
    elif leaf in ("k", "v") and len(shape) == 4 and shape[1] % sizes["data"] == 0:
        spec[1] = "data"           # batch=1 long-context: shard cache sequence dim
    if leaf in ("k", "v") and len(shape) == 4:
        if shape[2] % msz == 0 and shape[2] > 1:
            spec[2] = "model"      # KV heads
        elif shape[3] % msz == 0:
            spec[3] = "model"      # head_dim fallback (kv < model size)
    if leaf == "h" and len(shape) == 4 and shape[1] % msz == 0:
        spec[1] = "model"          # SSD heads
    return tuple(spec)


def to_placements(mesh, spec: tuple) -> tuple:
    """One ``Placement`` a mesh dim for ``spec``: ``Shard(d)`` on each mesh
    dim named at tensor dim ``d``, ``Replicate()`` elsewhere and on a mesh
    dim of one device (its one shard is the whole)."""
    out = []
    for name, size in zip(mesh.mesh_dim_names, tuple(mesh.shape)):
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_shape(mesh, shape: tuple, placements) -> tuple:
    """The per-device shape of an evenly sharded tensor."""
    shape = list(shape)
    for size, pl in zip(tuple(mesh.shape), placements):
        if isinstance(pl, Shard):
            assert shape[pl.dim] % size == 0, (shape, placements)
            shape[pl.dim] //= size
    return tuple(shape)


# --------------------------------------------------------------------------
# the port's per-layer parameters in the reference's layout
# --------------------------------------------------------------------------
class RefLeaf(NamedTuple):
    """Where a port parameter sits in the reference's tree: its ``path``
    (``blocks/<slot>/attn/wq``, ``tail/<i>/...``, ``embed``), its shape
    there (with the unit axis for ``blocks``) and whether it is stacked."""

    path: str
    shape: tuple
    stacked: bool


def reference_layout(model) -> dict:
    """Port parameter name (``layers.3.attn.wq``) -> :class:`RefLeaf`, the
    mapping of ``lm_params_to_jax``."""
    cfg = model.cfg
    p_len = len(cfg.layer_pattern)
    n_units = cfg.num_layers // p_len
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "layers":
            out[name] = RefLeaf(name, tuple(p.shape), False)
            continue
        l, rest = int(parts[1]), "/".join(parts[2:])
        if l < n_units * p_len:
            out[name] = RefLeaf(f"blocks/{l % p_len}/{rest}", (n_units, *p.shape), True)
        else:
            out[name] = RefLeaf(f"tail/{l - n_units * p_len}/{rest}", tuple(p.shape), False)
    return out


def param_shardings(mesh, model, moe_fsdp: bool = False) -> dict:
    """Port parameter name -> placements (the reference's
    ``param_shardings`` without the unit axis).  ``moe_fsdp=True`` forces
    FSDP sharding for expert weights even when expert-parallel placement
    is possible."""
    out = {}
    for name, ref in reference_layout(model).items():
        spec = param_spec(mesh, ref.path, ref.shape, moe_fsdp)
        if ref.stacked:
            assert spec[0] is None, (ref, spec)
            spec = spec[1:]
        out[name] = to_placements(mesh, spec)
    return out


def opt_shardings(mesh, model) -> dict:
    """Port parameter name -> placements of its Adam moments.  Where the
    reference's ZeRO-1 shards a stacked moment's unit axis, the layer's
    moment shards its own first free dim over the batch dims (the same
    bytes a device where that dim divides; replicated over them where
    none divides, as the reference's rule does for such a dim)."""
    b_axes = batch_axes(mesh)
    out = {}
    for name, ref in reference_layout(model).items():
        spec = opt_spec(mesh, ref.path, ref.shape)
        if ref.stacked:
            unit, spec = spec[0], list(spec[1:])
            if unit is not None:
                for i, (dim, ax) in enumerate(zip(ref.shape[1:], spec)):
                    if ax is None and dim % _axis_size(mesh, b_axes) == 0 and dim > 1:
                        spec[i] = b_axes
                        break
        out[name] = to_placements(mesh, tuple(spec))
    return out


def decode_state_shardings(mesh, state) -> object:
    """The decode state's tree (``init_decode_state``'s) with each tensor
    leaf replaced by its placements."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        if isinstance(node, torch.Tensor):
            return to_placements(mesh, decode_state_spec(mesh, path, tuple(node.shape)))
        return node

    return walk(state, "")
