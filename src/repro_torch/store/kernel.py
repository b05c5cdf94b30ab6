"""Batched set-associative tag probe (device cache lookup).

Port of ``repro.store.kernel``: for each id, the way ``w`` with
``tags[sets[i], w] == ids[i]`` (first match), or -1 on a miss.  A CPU
tensor takes :func:`probe_ref`; a CUDA tensor launches the hand-written
kernel ``tag_probe.cu`` beside this file, or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError


def probe_ref(tags: torch.Tensor, sets: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain torch version: way of ``ids[i]`` in ``tags[sets[i]]``, -1 on miss.

    Callers pre-mask padding ids to a value that can never be a tag (the
    CLOCK layer uses -1; tags hold vertex ids >= 0 or INVALID).
    """
    rows = tags[sets.long()]                        # (n, W)
    eq = rows == ids[:, None]
    if eq.shape[1] == 0:
        return torch.full(ids.shape, -1, dtype=torch.int32, device=ids.device)
    first = torch.argmax(eq.to(torch.uint8), dim=1)
    return torch.where(eq.any(1), first, -1).to(torch.int32)


def tag_probe_cuda(tags: torch.Tensor, sets: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: one thread per id reads its set's W tags."""
    _build.require_cuda_int32("tag_probe", tags=tags, sets=sets, ids=ids)
    if tags.ndim != 2 or ids.ndim != 1 or sets.shape != ids.shape:
        raise KernelContractError("tag_probe", "want (S, W) tags and (n,) sets and ids",
                                  {"tags": tuple(tags.shape), "sets": tuple(sets.shape),
                                   "ids": tuple(ids.shape)})
    W = tags.shape[1]
    (n,) = ids.shape
    out = torch.empty((n,), dtype=torch.int32, device=ids.device)
    if n:
        _build.launch("tag_probe", "tag_probe_launch", tags, sets, ids, out, n, W)
    return out


def tag_probe(tags: torch.Tensor, sets: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Batched cache-tag probe: plain version on the CPU, the kernel on CUDA."""
    if ids.device.type == "cpu":
        return probe_ref(tags, sets, ids)
    if ids.device.type != "cuda":
        raise KernelContractError("tag_probe", f"unsupported device {ids.device}")
    return tag_probe_cuda(tags.contiguous(), sets.contiguous(), ids.contiguous())
