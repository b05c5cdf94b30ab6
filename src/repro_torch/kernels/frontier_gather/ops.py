"""Public wrapper for the masked CSR frontier gather.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor
launches the hand-written kernel ``frontier_gather.cu`` or raises.  The
kernel writes the neighbor table and its mask in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.frontier_gather.ref import frontier_gather_ref


def frontier_gather_cuda(
    indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
    max_degree: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nbr (n, max_degree) int32, mask (n, max_degree) bool) from one
    launch of the CUDA kernel."""
    _build.require_cuda_int32(
        "frontier_gather", indptr=indptr, indices=indices, seeds=seeds
    )
    if seeds.ndim != 1 or max_degree < 0:
        raise KernelContractError("frontier_gather", "want (n,) seeds and max_degree >= 0",
                                  {"seeds": tuple(seeds.shape), "max_degree": max_degree})
    (n,) = seeds.shape
    nbr = torch.empty((n, max_degree), dtype=torch.int32, device=seeds.device)
    mask = torch.empty((n, max_degree), dtype=torch.bool, device=seeds.device)
    if n * max_degree:
        _build.launch(
            "frontier_gather", "frontier_gather_launch",
            indptr, indices, seeds, nbr, mask, n, max_degree,
        )
    return nbr, mask


def frontier_gather(
    indptr: torch.Tensor,   # (V+1,) int32
    indices: torch.Tensor,  # (E,) int32
    seeds: torch.Tensor,    # (n,) int32, INVALID padded, ids in [0, V)
    max_degree: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nbr (n, max_degree), mask) -- bit-identical to the plain version."""
    if seeds.device.type == "cpu":
        return frontier_gather_ref(indptr, indices, seeds, max_degree)
    if seeds.device.type != "cuda":
        raise KernelContractError("frontier_gather", f"unsupported device {seeds.device}")
    return frontier_gather_cuda(indptr, indices, seeds.contiguous(), max_degree)
