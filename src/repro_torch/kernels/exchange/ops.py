"""Public wrappers for the single-device valid-rows exchange, with autograd.

:func:`exchange_tables` inverts a cooperative layer's plan tables into
the index map of its exchange, and :func:`exchange_rows` moves the rows
through it, differentiable in ``H``.  A CPU tensor takes the plain
versions (:mod:`.ref`); a CUDA tensor launches the hand-written kernels
of ``exchange.cu`` -- counted as ``exchange_invert``, ``exchange`` and
``exchange_backward`` -- or the call raises.  The row kernels take the
launch geometry of the ``gather`` kernel (:func:`launch_shape`); both
directions equal their plain versions bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.exchange.ref import (
    exchange_backward_ref,
    exchange_forward_ref,
    exchange_tables_ref,
)
from repro_torch.kernels.gather.ops import MAX_K, launch_shape

INT32_MAX = 2**31 - 1
BWD_MAX_K = 4  # the backward's lanes hold a sum and a load a column


def _device_of(t: torch.Tensor, kernel: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise KernelContractError(kernel, f"unsupported device {t.device}")
    return t.device.type


def exchange_tables_cuda(slot_to_tilde: torch.Tensor, req_idx: torch.Tensor, cap_tilde: int,
                         cap_next: int, backward: bool):
    """``(fwd_src, bwd_src)`` of :func:`exchange_tables_ref` from the CUDA
    kernel: two fills of -1 and one launch."""
    _build.require_cuda_int32("exchange_invert", slot_to_tilde=slot_to_tilde, req_idx=req_idx)
    if slot_to_tilde.ndim != 3 or slot_to_tilde.shape[1] != slot_to_tilde.shape[0] or \
            req_idx.shape != slot_to_tilde.shape:
        raise KernelContractError("exchange_invert", "want two (P, P, cap_b) tables",
                                  {"slot_to_tilde": tuple(slot_to_tilde.shape),
                                   "req_idx": tuple(req_idx.shape)})
    P, _, cap_b = slot_to_tilde.shape
    if P * P > 65535 or P * max(cap_tilde, cap_next) > INT32_MAX:
        raise KernelContractError("exchange_invert", "rows exceed int32 or P exceeds 255",
                                  {"P": P, "cap_tilde": cap_tilde, "cap_next": cap_next})
    dev = slot_to_tilde.device
    fwd_src = torch.full((P, cap_tilde), -1, dtype=torch.int32, device=dev)
    bwd_src = (torch.full((P, cap_next, P), -1, dtype=torch.int32, device=dev)
               if backward else None)
    if cap_b and cap_tilde:
        _build.launch("exchange", "exchange_invert_launch", slot_to_tilde, req_idx, fwd_src,
                      bwd_src, P, cap_b, cap_tilde, cap_next, counter="exchange_invert")
    return fwd_src, bwd_src


def _rows_cuda(kernel: str, entry: str, table: torch.Tensor, src: torch.Tensor,
               max_k: int) -> torch.Tensor:
    """``(n, d)`` rows from ``table`` (``(V, d)``) through ``src`` (``(n,
    ways)``) by one launch of a row kernel."""
    V, d = table.shape
    n, ways = src.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n * d:
        vec4 = d % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        group, k = launch_shape(d, vec4)
        _build.launch("exchange", entry, table, src, out, n, ways, d, V, int(vec4), group,
                      min(k, max_k), counter=kernel)
    return out


def exchange_forward_cuda(H: torch.Tensor, fwd_src: torch.Tensor) -> torch.Tensor:
    """``(P, cap_tilde, d)`` output of the forward kernel for ``H`` of shape
    ``(P, cap_next, d)`` and ``fwd_src`` of shape ``(P, cap_tilde)``."""
    _build.require_cuda("exchange", torch.float32, H=H)
    _build.require_cuda_int32("exchange", fwd_src=fwd_src)
    if H.ndim != 3 or fwd_src.ndim != 2 or fwd_src.shape[0] != H.shape[0]:
        raise KernelContractError("exchange", "want (P, cap_next, d) rows and (P, cap_tilde) "
                                  "sources", {"H": tuple(H.shape),
                                              "fwd_src": tuple(fwd_src.shape)})
    d = H.shape[-1]
    out = _rows_cuda("exchange", "exchange_forward_launch", H.reshape(-1, d),
                     fwd_src.reshape(-1, 1), MAX_K)
    return out.reshape(*fwd_src.shape, d)


def exchange_backward_cuda(grad_out: torch.Tensor, bwd_src: torch.Tensor) -> torch.Tensor:
    """``(P, cap_next, d)`` gradient of ``H`` from the backward kernel, for
    ``grad_out`` of shape ``(P, cap_tilde, d)`` and ``bwd_src`` of shape
    ``(P, cap_next, P)``."""
    _build.require_cuda("exchange_backward", torch.float32, grad_out=grad_out)
    _build.require_cuda_int32("exchange_backward", bwd_src=bwd_src)
    P = grad_out.shape[0] if grad_out.ndim == 3 else -1
    if bwd_src.ndim != 3 or bwd_src.shape[0] != P or bwd_src.shape[2] != P:
        raise KernelContractError("exchange_backward", "want (P, cap_tilde, d) gradients and "
                                  "(P, cap_next, P) sources",
                                  {"grad_out": tuple(grad_out.shape),
                                   "bwd_src": tuple(bwd_src.shape)})
    d = grad_out.shape[-1]
    out = _rows_cuda("exchange_backward", "exchange_backward_launch", grad_out.reshape(-1, d),
                     bwd_src.reshape(-1, P), BWD_MAX_K)
    return out.reshape(*bwd_src.shape[:-1], d)


def exchange_tables(slot_to_tilde: torch.Tensor, req_idx: torch.Tensor, cap_tilde: int,
                    cap_next: int, backward: bool
                    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The index map of a layer's exchange under the single-device executor:
    ``fwd_src`` (``(P, cap_tilde)``, the flat row of ``H`` each output row
    copies) and, with ``backward``, ``bwd_src`` (``(P, cap_next, P)``, the
    flat output row of each requester of each row of ``H``); -1 for none.
    ``slot_to_tilde[p, q, s]`` and ``req_idx[q, p, s]`` are one bucket
    slot's two ends (:class:`repro_torch.core.CoopLayer`)."""
    if _device_of(slot_to_tilde, "exchange_invert") == "cpu":
        return exchange_tables_ref(slot_to_tilde, req_idx, cap_tilde, cap_next, backward)
    return exchange_tables_cuda(slot_to_tilde.contiguous(), req_idx.contiguous(), cap_tilde,
                                cap_next, backward)


class _ExchangeRows(torch.autograd.Function):
    """The forward copies rows through ``fwd_src``; the backward sums each
    row's requesters through ``bwd_src``.  Saves only ``bwd_src``."""

    @staticmethod
    def forward(ctx, H, fwd_src, bwd_src):
        ctx.save_for_backward(bwd_src)
        if _device_of(H, "exchange") == "cpu":
            return exchange_forward_ref(H, fwd_src)
        return exchange_forward_cuda(H.contiguous(), fwd_src.contiguous())

    @staticmethod
    def backward(ctx, grad_out):
        (bwd_src,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if bwd_src is None:
            raise RuntimeError("exchange_rows: H takes a gradient but no bwd_src was built")
        if _device_of(grad_out, "exchange_backward") == "cpu":
            return exchange_backward_ref(grad_out, bwd_src), None, None
        return exchange_backward_cuda(grad_out.contiguous(), bwd_src), None, None


def exchange_rows(H: torch.Tensor, fwd_src: torch.Tensor,
                  bwd_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(P, cap_tilde, d)`` rows of ``H`` (``(P, cap_next, d)``) through the
    tables of :func:`exchange_tables`; differentiable in ``H`` when
    ``bwd_src`` is given."""
    return _ExchangeRows.apply(H, fwd_src, bwd_src)
