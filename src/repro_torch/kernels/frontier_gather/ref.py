"""Plain torch version of the masked CSR frontier gather.

Bit-identical to ``repro.kernels.frontier_gather.ref.frontier_gather_ref``
and to the CUDA kernel beside it: the padded, degree-capped neighbor
table every sampler starts from.
"""
from __future__ import annotations

import torch

_INVALID = 2**31 - 1


def frontier_gather_ref(
    indptr: torch.Tensor,   # (V+1,) int32 CSR row pointer
    indices: torch.Tensor,  # (E,) int32 source ids
    seeds: torch.Tensor,    # (n,) int32 vertex ids, INVALID padded
    max_degree: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nbr (n, max_degree) INVALID-padded, mask (n, max_degree))."""
    num_edges = indices.shape[0]
    safe = torch.where(seeds == _INVALID, 0, seeds).long()
    offs = indptr[safe]
    deg = indptr[safe + 1] - offs
    pos = torch.arange(max_degree, dtype=torch.int32, device=seeds.device)[None, :]
    idx = (offs[:, None] + pos).clamp(0, max(num_edges - 1, 0))
    if num_edges:
        nbr = indices[idx.long()]
    else:
        nbr = torch.full(idx.shape, _INVALID, dtype=torch.int32, device=seeds.device)
    mask = (pos < deg[:, None]) & (seeds != _INVALID)[:, None]
    nbr = torch.where(mask, nbr, _INVALID)
    return nbr, mask
