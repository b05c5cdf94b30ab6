"""Plain torch version of the masked embedding gather (feature loading)."""
from __future__ import annotations

import torch


def gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[i] = table[ids[i]]; ids < 0 or >= V (INVALID padding) -> 0."""
    V = table.shape[0]
    valid = (ids >= 0) & (ids < V)
    rows = table[ids.clamp(0, V - 1).long()]
    return torch.where(valid[..., None], rows, 0.0)
