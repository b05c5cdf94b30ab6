"""Public wrapper for the masked embedding gather.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor
launches the hand-written kernel ``gather.cu`` or raises.  The wrapper
sets the launch geometry: float4 columns when ``d % 4 == 0`` and the
table and output are 16-byte aligned (else floats), and from the row's
width the lanes a row (``group``) and the columns a lane holds in flight
per row (``k``); the kernel gives each warp one step of rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.gather.ref import gather_ref

MAX_K = 8  # the widest instantiation: 8 columns a lane per row


def launch_shape(d: int, vec4: bool) -> tuple[int, int]:
    """``(group, k)`` for rows of ``d`` floats: ``c`` columns a row (d / 4
    float4 or d floats), a group of the next power of two >= c lanes (at
    most 32) and ``ceil(c / group)`` columns a lane, at most ``MAX_K`` at a
    time."""
    c = d // 4 if vec4 else d
    group = min(32, 1 << (c - 1).bit_length())
    return group, min(MAX_K, -(-c // group))


def gather_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(n, d) rows of a float32 ``(V, d)`` table from the CUDA kernel."""
    _build.require_cuda("gather", torch.float32, table=table)
    _build.require_cuda_int32("gather", ids=ids)
    if table.ndim != 2 or ids.ndim != 1:
        raise KernelContractError("gather", "want a (V, d) table and (n,) ids",
                                  {"table": tuple(table.shape), "ids": tuple(ids.shape)})
    V, d = table.shape
    (n,) = ids.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n * d:
        vec4 = d % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        _build.launch("gather", "gather_launch", table, ids, out, n, d, V, int(vec4),
                      *launch_shape(d, vec4))
    return out


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``(..., d)`` rows of ``table`` for ``ids`` of any shape; INVALID,
    negative and out-of-range ids give zero rows, on either device."""
    if ids.device.type == "cpu":
        return gather_ref(table, ids)
    if ids.device.type != "cuda":
        raise KernelContractError("gather", f"unsupported device {ids.device}")
    out = gather_cuda(table.contiguous(), ids.reshape(-1).contiguous())
    return out.reshape(*ids.shape, table.shape[1])
