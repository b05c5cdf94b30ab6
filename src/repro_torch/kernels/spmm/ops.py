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
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.spmm.ref import spmm_backward_ref, spmm_ref


def _check(kernel: str, rows: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor):
    _build.require_cuda(kernel, torch.float32, rows=rows)
    _build.require_cuda_int32(kernel, nbr_idx=nbr_idx)
    _build.require_cuda(kernel, torch.bool, mask=mask)
    if rows.ndim != 2 or nbr_idx.ndim != 2 or mask.shape != nbr_idx.shape:
        raise KernelContractError(
            kernel, "want (rows, d), (n, w) indices and an (n, w) mask",
            {"rows": tuple(rows.shape), "nbr_idx": tuple(nbr_idx.shape),
             "mask": tuple(mask.shape)},
        )


def spmm_cuda(src: torch.Tensor, nbr_idx: torch.Tensor, mask: torch.Tensor,
              mean: bool) -> torch.Tensor:
    """(n, d) aggregation from the CUDA forward kernel."""
    _check("spmm", src, nbr_idx, mask)
    S, d = src.shape
    n, w = nbr_idx.shape
    if S == 0 and bool(mask.any()):
        raise KernelContractError("spmm", "masked slots into an empty source matrix",
                                  {"src": tuple(src.shape)})
    out = torch.empty((n, d), dtype=src.dtype, device=src.device)
    if n * d:
        _build.launch("spmm", "spmm_forward_launch", src, nbr_idx, mask, out,
                      n, w, d, max(S, 1), int(mean))
    return out


def spmm_backward_cuda(grad_out: torch.Tensor, nbr_idx: torch.Tensor,
                       mask: torch.Tensor, num_src: int, mean: bool) -> torch.Tensor:
    """(num_src, d) source gradient from the CUDA backward kernel.

    The kernel transposes the masked slots by counting (count, scan, place)
    and adds each source row's gradients in slot order, one warp per row
    (see ``spmm.cu``): a memset and 4 kernel launches, counted as one.
    Every output row is written by the kernel, so nothing is zero-filled.
    """
    _check("spmm_backward", grad_out, nbr_idx, mask)
    n, d = grad_out.shape
    w = nbr_idx.shape[1]
    if nbr_idx.shape[0] != n:
        raise KernelContractError("spmm_backward", "gradient rows != index rows",
                                  {"grad_out": n, "nbr_idx": nbr_idx.shape[0]})
    if n * w >= 2**31 - 1 or num_src >= 2**31 - 1:
        raise KernelContractError("spmm_backward", "slots or rows exceed int32",
                                  {"n*w": n * w, "num_src": num_src})
    dev = grad_out.device
    if not (n * d * w and num_src):
        return torch.zeros((num_src, d), dtype=grad_out.dtype, device=dev)
    grad_src = torch.empty((num_src, d), dtype=grad_out.dtype, device=dev)
    ints = _build.call_int("spmm", "spmm_backward_scratch_ints", n, w, num_src)
    scratch = torch.empty((ints,), dtype=torch.int32, device=dev)
    _build.launch("spmm", "spmm_backward_launch", grad_out, nbr_idx, mask, grad_src, scratch,
                  n, w, d, num_src, int(mean), counter="spmm_backward")
    return grad_src


def _device_of(t: torch.Tensor, kernel: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise KernelContractError(kernel, f"unsupported device {t.device}")
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
