"""Padded, fixed-capacity vertex-set operations (port of ``repro.core.frontier``).

Every expansion set ``S^l`` is a fixed-capacity int32 vector padded with
``INVALID`` and kept *sorted* (valid ids first, then padding -- INVALID
is int32 max, so a plain sort yields this layout).  Fixed capacities keep
the plan's shapes independent of the data, exactly as in the JAX package,
so plans from both packages compare leaf by leaf.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import INVALID

PLAN_BACKENDS = ("reference", "fused")


def _check_backend(backend: str) -> None:
    if backend not in PLAN_BACKENDS:
        raise ValueError(
            f"unknown plan backend {backend!r}; expected one of {PLAN_BACKENDS}"
        )


def pad_to(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad / truncate a 1-D id vector to capacity ``cap``."""
    n = ids.shape[0]
    if n >= cap:
        return ids[:cap]
    fill = torch.full((cap - n,), INVALID, dtype=ids.dtype, device=ids.device)
    return torch.cat([ids, fill])


def unique_padded(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Sorted unique ids with INVALID padding, capacity ``cap``.

    Overflow policy: if the true unique count exceeds ``cap`` the smallest
    ``cap`` ids are kept.
    """
    return pad_to(torch.unique(ids.reshape(-1), sorted=True), cap)


def union_padded(a: torch.Tensor, b: torch.Tensor, cap: int) -> torch.Tensor:
    return unique_padded(torch.cat([a.reshape(-1), b.reshape(-1)]), cap)


def lookup(sorted_ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Index of each query in a sorted padded id vector; -1 if absent.

    ``queries`` may contain INVALID (maps to -1).
    """
    pos = torch.searchsorted(sorted_ids, queries).to(torch.int32)
    pos = pos.clamp(0, sorted_ids.shape[0] - 1)
    hit = (sorted_ids[pos.long()] == queries) & (queries != INVALID)
    return torch.where(hit, pos, -1).to(torch.int32)


def contains(sorted_ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    return lookup(sorted_ids, queries) >= 0


def count_valid(ids: torch.Tensor) -> torch.Tensor:
    return (ids != INVALID).sum()


def multiplicity(sorted_ids: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts (cap,) int32, starts)``: the occurrence count of each run of
    equal *valid* ids of a sorted padded vector, by run, and where each run
    starts.  The JAX package's scatter-add wraps a negative run index and
    drops one past ``cap``; so does this.

    Used by the theory harness to measure |T^l| (eq. 5): vertices reached
    from exactly one seed.
    """
    ids = sorted_ids
    left = torch.cat([torch.full((1,), -1, dtype=ids.dtype, device=ids.device), ids[:-1]])
    starts = (ids != left) & (ids != INVALID)
    seg = torch.cumsum(starts, 0) - 1  # run index per element
    seg = torch.where(ids == INVALID, cap - 1, seg)
    seg = torch.where(seg < 0, seg + cap, seg)
    keep = (seg >= 0) & (seg < cap) & (ids != INVALID)
    counts = torch.zeros((cap,), dtype=torch.int32, device=ids.device)
    counts.index_add_(0, seg[keep], torch.ones_like(seg[keep], dtype=torch.int32))
    return counts, starts


def compact(ids: torch.Tensor, keep: torch.Tensor, cap: int) -> torch.Tensor:
    """Keep ``ids[keep]``, drop the rest; result sorted + INVALID-padded."""
    masked = torch.where(keep, ids, INVALID)
    out, _ = torch.sort(masked.reshape(-1))
    return pad_to(out, cap)


def unique_with_inverse(
    ids: torch.Tensor, cap: int, backend: str = "reference"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(uniq (cap,), inv (m,)): dedup + rank of every id in the result.

    ``uniq`` equals :func:`unique_padded` and ``inv`` equals :func:`lookup`
    of the flattened input against it; both backends are bit-identical.
    ``"fused"`` routes through :mod:`repro_torch.kernels.unique_compact`
    (the CUDA kernel on a CUDA tensor).
    """
    _check_backend(backend)
    flat = ids.reshape(-1)
    if backend == "fused":
        from repro_torch import kernels

        return kernels.unique_with_inverse(flat, cap)
    uniq = unique_padded(flat, cap)
    return uniq, lookup(uniq, flat)


def unique_compact(ids: torch.Tensor, cap: int, backend: str = "reference") -> torch.Tensor:
    """Backend-dispatched :func:`unique_padded` (no inverse)."""
    _check_backend(backend)
    if backend == "fused":
        from repro_torch import kernels

        return kernels.unique_compact(ids.reshape(-1), cap)
    return unique_padded(ids, cap)


def take_rows(H: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``H[idx]`` with a zero row wherever ``idx < 0`` (padding).

    Differentiable in ``H``.  Padding slots read spread-out rows (their
    position modulo ``len(H)``) before the mask zeroes them, instead of
    all reading row 0: autograd's scatter-add for a row gather walks each
    run of equal indices in one warp on CUDA, and a plan's padding, most
    slots of the deep layers, made one run of ~10^5 slots on row 0.
    """
    valid = idx >= 0
    spread = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape) % H.shape[0]
    return torch.where(valid[..., None], H[torch.where(valid, idx.long(), spread)], 0.0)
