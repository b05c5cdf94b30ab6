"""Public wrappers for the fused unique-and-compact frontier op.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor is
sorted with ``torch.sort`` (the JAX package leaves the sort to XLA too)
and the hand-written kernel ``unique_compact.cu`` does everything after
the sort, the inverse's scatter back to input order included, or the
call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.unique_compact.ref import unique_with_inverse_ref


def unique_compact_cuda(
    sorted_ids: torch.Tensor, cap: int, order: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(inv (m,), uniq (cap,)) of ascending ids, from the CUDA kernel.

    ``order`` is the sort's int64 permutation: ``inv[order[j]]`` is the rank
    of ``sorted_ids[j]``, so ``inv`` comes out in input order (an identity
    ``order`` gives it in sorted order).  One kernel launch, after a memset
    of its scratch past one tile of ids (see the kernel's note), counted as
    one; no host synchronisation.
    """
    _build.require_cuda_int32("unique_compact", sorted_ids=sorted_ids)
    _build.require_cuda("unique_compact", torch.int64, order=order)
    if not 1 <= cap < 2**31:
        raise KernelContractError("unique_compact", "cap must be in [1, 2**31)", {"cap": cap})
    if sorted_ids.ndim != 1 or order.shape != sorted_ids.shape:
        raise KernelContractError("unique_compact", "want (m,) sorted ids and their (m,) order",
                                  {"sorted_ids": tuple(sorted_ids.shape),
                                   "order": tuple(order.shape)})
    (m,) = sorted_ids.shape
    if m >= 2**31:
        raise KernelContractError("unique_compact", "m exceeds the int32 index range",
                                  {"m": m})
    dev = sorted_ids.device
    inv = torch.empty((m,), dtype=torch.int32, device=dev)
    uniq = torch.empty((cap,), dtype=torch.int32, device=dev)
    ints = _build.call_int("unique_compact", "unique_compact_scratch_ints", m)
    scratch = torch.empty((ints,), dtype=torch.int32, device=dev)
    _build.launch("unique_compact", "unique_compact_launch",
                  sorted_ids, order, inv, uniq, scratch, m, cap)
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
        raise KernelContractError("unique_compact", f"unsupported device {flat.device}")
    s, order = torch.sort(flat)
    inv, uniq = unique_compact_cuda(s.contiguous(), cap, order)
    return uniq, inv


def unique_compact(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Sorted unique ids with INVALID padding (fused unique only)."""
    uniq, _ = unique_with_inverse(ids, cap)
    return uniq
