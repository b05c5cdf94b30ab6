"""Plain torch version of the fused unique-and-compact frontier op.

Mirrors ``repro.kernels.unique_compact.ref.unique_with_inverse_ref``:
one sort of the flat ids, first-occurrence flags, cumulative ranks and
two scatters.

* ``uniq``: sorted unique ids, INVALID-padded, smallest ``cap`` kept on
  overflow (INVALID takes part as an ordinary value that sorts last);
* ``inv[j]``: position of ``ids[j]`` in ``uniq``, or -1 when ``ids[j]`` is
  INVALID or was dropped by the overflow policy (rank >= cap).
"""
from __future__ import annotations

import torch

_INVALID = 2**31 - 1


def unique_compact_sorted_ref(
    s: torch.Tensor, cap: int, order: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(inv (m,), uniq (cap,)) from ascending ids -- what the kernel computes.

    ``inv`` is in sorted order, or in input order given the sort's
    permutation ``order`` (``inv[order[j]]`` is the rank of ``s[j]``)."""
    m = s.shape[0]
    first = torch.ones(m, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    rank = (torch.cumsum(first, 0) - 1).to(torch.int32)
    # rank >= cap parks in slot `cap`, sliced off below; all writers of a
    # slot < cap carry the same value, so the duplicate scatter is exact
    slot = torch.where(rank < cap, rank, cap).long()
    uniq = torch.full((cap + 1,), _INVALID, dtype=s.dtype, device=s.device)
    uniq[slot] = s
    inv_sorted = torch.where((rank < cap) & (s != _INVALID), rank, -1).to(torch.int32)
    if order is None:
        return inv_sorted, uniq[:cap]
    inv = torch.empty_like(inv_sorted)
    inv[order] = inv_sorted
    return inv, uniq[:cap]


def unique_with_inverse_ref(
    ids: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(uniq (cap,), inv (m,)) for a flat int32 id vector."""
    s, order = torch.sort(ids.reshape(-1), stable=True)
    inv, uniq = unique_compact_sorted_ref(s, cap, order)
    return uniq, inv
