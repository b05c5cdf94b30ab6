"""Plain torch version of the CSR indptr expansion (row id of each edge slot)."""
from __future__ import annotations

import torch


def expand_indptr_ref(indptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """(num_edges,) int32 row id of each edge slot, -1 past ``indptr[-1]``.

    ``row[e] = r`` iff ``indptr[r] <= e < indptr[r+1]`` (the number of
    entries ``<= e``, minus one); slots at or beyond the total edge count
    ``indptr[-1]`` get -1.  ``indptr``: (R+1,) int32, ascending.
    """
    e = torch.arange(num_edges, dtype=torch.int32, device=indptr.device)
    row = torch.searchsorted(indptr, e, right=True, out_int32=True) - 1
    return torch.where(e < indptr[-1], row, -1)
