"""Public wrapper for the CSR indptr expansion.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor
launches the hand-written kernel ``expand_indptr.cu`` or raises.  Any
``num_edges`` is taken: the kernel has no block-multiple constraint.  Each
kernel thread writes 4 slots with one 16-byte store, so the output must
start on a 16-byte boundary (``torch.empty`` gives one; checked).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.expand_indptr.ref import expand_indptr_ref


def expand_indptr_cuda(indptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """(num_edges,) int32 row ids from the CUDA kernel."""
    _build.require_cuda_int32("expand_indptr", indptr=indptr)
    if indptr.ndim != 1 or indptr.shape[0] < 1:
        raise KernelContractError("expand_indptr", "want an (R+1,) indptr",
                                  {"indptr": tuple(indptr.shape)})
    if not 0 <= num_edges < 2**31 - 128:
        raise KernelContractError("expand_indptr", "num_edges outside [0, 2**31 - 128)",
                                  {"num_edges": num_edges})
    rows = torch.empty((num_edges,), dtype=torch.int32, device=indptr.device)
    if rows.data_ptr() % 16:
        raise KernelContractError("expand_indptr", "the output is not 16-byte aligned",
                                  {"address": rows.data_ptr()})
    if num_edges:
        _build.launch("expand_indptr", "expand_indptr_launch", indptr, rows, num_edges,
                      indptr.shape[0])
    return rows


def expand_indptr(indptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """(num_edges,) int32 row id per edge slot, -1 past ``indptr[-1]``."""
    if indptr.device.type == "cpu":
        return expand_indptr_ref(indptr, num_edges)
    if indptr.device.type != "cuda":
        raise KernelContractError("expand_indptr", f"unsupported device {indptr.device}")
    return expand_indptr_cuda(indptr.contiguous(), num_edges)
