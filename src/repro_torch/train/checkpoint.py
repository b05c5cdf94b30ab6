"""Flat-npz checkpoints of a GNN or an LM (port of ``repro.train.checkpoint``).

A checkpoint is ``<path>.npz`` with one array per parameter, keyed as the
JAX package flattens its parameter pytree (dict keys and list indices
joined by ``/``: ``layers/<l>/<name>`` for a GNN, the names
:func:`repro_torch.models.gnn.params_from_jax` reads; ``embed``,
``blocks/<slot>/<sub>/<name>`` with the units stacked, ``tail/<t>/...``
for an LM, the layout :func:`repro_torch.models.transformer.lm_params_to_jax`
gives), and ``<path>.json`` with the sorted ``keys`` and the caller's
``extra``.  So a checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Union

import numpy as np

from repro_torch.models.gnn import GNN, params_from_jax
from repro_torch.models.transformer import LM, lm_params_from_jax, lm_params_to_jax

Model = Union[GNN, LM]


def _tree(model: Model) -> dict:
    """The model's parameters in the JAX package's pytree layout (numpy)."""
    if isinstance(model, LM):
        return lm_params_to_jax(model, model.cfg)
    return {"layers": [{name: p.detach().cpu().numpy() for name, p in layer.named_parameters()}
                       for layer in model.layers]}


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _fill(tree, data, prefix: str = ""):
    """``tree``'s structure with each leaf read from ``data`` by its key,
    in the leaf's dtype."""
    if isinstance(tree, dict):
        return {k: _fill(v, data, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, data, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    leaf = np.asarray(data[prefix])
    if leaf.shape != tree.shape:
        raise ValueError(f"checkpoint {prefix}: shape {leaf.shape}, want {tree.shape}")
    return leaf.astype(tree.dtype)


def save_checkpoint(path: str, model: Model, extra: dict[str, Any] | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(_tree(model))
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    meta = {"keys": sorted(flat), "extra": extra or {}}
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, like: Model) -> Model:
    """A new model of ``like``'s kind, configuration and device holding the
    checkpoint's parameters; raises ``ValueError`` if its keys or shapes
    differ from ``like``'s."""
    want = _tree(like)
    keys = sorted(_flatten(want))
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        if sorted(data.files) != keys:
            raise ValueError(
                f"checkpoint structure mismatch: keys {sorted(data.files)}, want {keys}"
            )
        tree = _fill(want, data)
    device = next(like.parameters()).device
    if isinstance(like, LM):
        return lm_params_from_jax(tree, like.cfg, device=device)
    return params_from_jax(tree, like.cfg, device=device)
