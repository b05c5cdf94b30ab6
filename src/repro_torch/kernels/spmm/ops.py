"""Public wrappers for the neighbor aggregation (SpMM), with autograd.

``spmm_sum`` and ``spmm_mean`` are differentiable in ``src``.  A CPU
tensor takes the plain versions (:mod:`.ref`); a CUDA tensor launches
the hand-written kernels of ``spmm.cu`` -- the forward counted as
``spmm``, the backward as ``spmm_backward`` -- or the call raises.  Both
directions are deterministic and equal their plain versions bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.ref import _degree, backward_order, spmm_backward_ref, spmm_ref


def _check(kernel: str, rows: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor):
    _build.require_cuda(kernel, torch.float32, rows=rows)
    _build.require_cuda_int32(kernel, nbr_idx=nbr_idx)
    _build.require_cuda(kernel, torch.bool, mask=mask)
    if rows.ndim != 2 or nbr_idx.ndim != 2 or mask.shape != nbr_idx.shape:
        raise ValueError(
            f"{kernel}: want (rows, d), (n, w) indices and an (n, w) mask, got "
            f"{tuple(rows.shape)}, {tuple(nbr_idx.shape)}, {tuple(mask.shape)}"
        )


def spmm_cuda(src: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor,
              mean: bool) -> torch.Tensor:
    """(n, d) aggregation from the CUDA forward kernel."""
    _check("spmm", src, nbr_idx, mask)
    S, d = src.shape
    n, w = nbr_idx.shape
    if S == 0 and bool(mask.any()):
        raise ValueError("spmm: masked slots into an empty source matrix")
    out = torch.empty((n, d), dtype=src.dtype, device=src.device)
    if n * d:
        _build.launch("spmm", "spmm_forward_launch", src, nbr_idx, mask, out,
                      n, w, d, max(S, 1), int(mean))
    return out


def spmm_backward_cuda(grad_out: torch.Tensor, nbr_idx: torch.Tensor,
                       mask: torch.Tensor, num_src: int, mean: bool) -> torch.Tensor:
    """(num_src, d) source gradient from the CUDA backward kernel.

    The slots are put in source-row order by a stable ``torch.sort``
    (:func:`.ref.backward_order`), as the JAX package leaves sorts to XLA;
    the kernel then adds each row's run in order, without atomics.
    """
    _check("spmm_backward", grad_out, nbr_idx, mask)
    n, d = grad_out.shape
    if nbr_idx.shape[0] != n:
        raise ValueError(f"spmm_backward: {n} gradient rows for {nbr_idx.shape[0]} index rows")
    grad_src = torch.zeros((num_src, d), dtype=grad_out.dtype, device=grad_out.device)
    if n * d * nbr_idx.shape[1] and num_src:
        g = (grad_out / _degree(mask, grad_out.dtype)).contiguous() if mean else grad_out
        keys, slots = backward_order(nbr_idx, mask, num_src)
        _build.launch("spmm", "spmm_backward_launch", g, keys, slots, grad_src,
                      keys.numel(), nbr_idx.shape[1], d, num_src, counter="spmm_backward")
    return grad_src


def _device_of(t: torch.Tensor, kernel: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {t.device}")
    return t.device.type


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, nbr_idx, mask, mean):
        ctx.save_for_backward(nbr_idx, mask)
        ctx.mean, ctx.num_src = mean, src.shape[0]
        if _device_of(src, "spmm") == "cpu":
            return spmm_ref(src, nbr_idx, mask, mean=mean)
        return spmm_cuda(src.contiguous(), nbr_idx.contiguous(), mask.contiguous(), mean)

    @staticmethod
    def backward(ctx, grad_out):
        nbr_idx, mask = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if _device_of(grad_out, "spmm_backward") == "cpu":
            grad = spmm_backward_ref(grad_out, nbr_idx, mask, ctx.num_src, mean=ctx.mean)
        else:
            grad = spmm_backward_cuda(grad_out.contiguous(), nbr_idx.contiguous(),
                                      mask.contiguous(), ctx.num_src, ctx.mean)
        return grad, None, None, None


def spmm_sum(src: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked sum aggregation over sampled neighbors: ``(S, d) -> (n, d)``."""
    return _Spmm.apply(src, nbr_idx, mask, False)


def spmm_mean(src: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean aggregation (divided by ``max(deg, 1)``)."""
    return _Spmm.apply(src, nbr_idx, mask, True)
