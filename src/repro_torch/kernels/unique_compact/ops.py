"""Public wrappers for the fused unique-and-compact frontier op.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor is
sorted with ``torch.sort`` (the JAX package leaves the sort to XLA too)
and the hand-written kernel ``unique_compact.cu`` does everything after
the sort, or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.unique_compact.ref import unique_with_inverse_ref


def unique_compact_cuda(
    sorted_ids: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(inv_sorted (m,), uniq (cap,)) of ascending ids, from the CUDA kernel."""
    _build.require_cuda_int32("unique_compact", sorted_ids=sorted_ids)
    if cap < 1:
        raise ValueError(f"unique_compact: cap must be >= 1, got {cap}")
    (m,) = sorted_ids.shape
    if m >= 2**31:
        raise ValueError(f"unique_compact: m={m} exceeds the int32 index range")
    inv = torch.empty((m,), dtype=torch.int32, device=sorted_ids.device)
    uniq = torch.empty((cap,), dtype=torch.int32, device=sorted_ids.device)
    _build.launch(
        "unique_compact", "unique_compact_launch", sorted_ids, inv, uniq, m, cap
    )
    return inv, uniq


def unique_with_inverse(
    ids: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(uniq (cap,), inv (m,)) of a flat int32 id vector.

    ``uniq`` equals ``frontier.unique_padded(ids, cap)`` and ``inv`` equals
    ``frontier.lookup(uniq, ids)``, bit for bit, on either device.
    """
    flat = ids.reshape(-1)
    if flat.device.type == "cpu":
        return unique_with_inverse_ref(flat, cap)
    if flat.device.type != "cuda":
        raise ValueError(f"unique_compact: unsupported device {flat.device}")
    s, order = torch.sort(flat)
    inv_sorted, uniq = unique_compact_cuda(s.contiguous(), cap)
    inv = torch.empty_like(inv_sorted)
    inv[order] = inv_sorted
    return uniq, inv


def unique_compact(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Sorted unique ids with INVALID padding (fused unique only)."""
    uniq, _ = unique_with_inverse(ids, cap)
    return uniq
