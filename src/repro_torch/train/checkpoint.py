"""Flat-npz GNN checkpoints (port of ``repro.train.checkpoint``).

A checkpoint is ``<path>.npz`` with one array per parameter, keyed as the
JAX package flattens its parameter pytree (``layers/<l>/<name>``, the
names :func:`repro_torch.models.gnn.params_from_jax` reads), and
``<path>.json`` with the sorted ``keys`` and the caller's ``extra``.  So a
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from repro_torch.models.gnn import GNN, params_from_jax


def _flatten(model: GNN) -> dict[str, np.ndarray]:
    return {
        f"layers/{l}/{name}": p.detach().cpu().numpy()
        for l, layer in enumerate(model.layers)
        for name, p in layer.named_parameters()
    }


def save_checkpoint(path: str, model: GNN, extra: dict[str, Any] | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(model)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    meta = {"keys": sorted(flat), "extra": extra or {}}
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, like: GNN) -> GNN:
    """A new :class:`GNN` of ``like``'s configuration and device holding the
    checkpoint's parameters; raises ``ValueError`` if its keys or shapes
    differ from ``like``'s."""
    want = _flatten(like)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        if sorted(data.files) != sorted(want):
            raise ValueError(
                f"checkpoint structure mismatch: keys {sorted(data.files)}, want {sorted(want)}"
            )
        layers = [{} for _ in like.layers]
        for key, leaf in want.items():
            _, l, name = key.split("/")
            layers[int(l)][name] = np.asarray(data[key]).astype(leaf.dtype)
    return params_from_jax({"layers": layers}, like.cfg, device=next(like.parameters()).device)
