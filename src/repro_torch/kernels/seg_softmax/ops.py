"""Public wrapper for the masked edge softmax (GAT), with autograd.

``seg_softmax`` is differentiable in the logits.  A CPU tensor takes the
plain versions (:mod:`.ref`); a CUDA tensor launches the hand-written
kernels of ``seg_softmax.cu`` -- the forward counted as ``seg_softmax``,
the backward as ``seg_softmax_backward`` -- or the call raises.  The
kernels take contiguous, 16-byte-aligned floats; the autograd op copies
an input that is not aligned.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.seg_softmax.ref import seg_softmax_backward_ref, seg_softmax_ref

ALIGN = 16


def _check(kernel: str, mask: torch.Tensor, **floats: torch.Tensor):
    _build.require_cuda(kernel, torch.float32, **floats)
    _build.require_cuda(kernel, torch.bool, mask=mask)
    for key, t in floats.items():
        if t.ndim not in (2, 3) or tuple(t.shape[:2]) != tuple(mask.shape):
            raise KernelContractError(
                kernel, f"want (n, w) or (n, w, h) {key} over an (n, w) mask",
                {key: tuple(t.shape), "mask": tuple(mask.shape)},
            )
        if t.data_ptr() % ALIGN:  # the kernels load and store 16 bytes at a time
            raise KernelContractError(kernel, f"{key} is not {ALIGN}-byte aligned",
                                      {"address": t.data_ptr()})


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and :data:`ALIGN`-byte aligned (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def _dims(t: torch.Tensor) -> tuple[int, int, int]:
    n, w = t.shape[:2]
    return n, w, t.shape[2] if t.ndim == 3 else 1


def seg_softmax_cuda(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax of ``(n, w[, h])`` logits over the valid slots, from the
    CUDA forward kernel."""
    _check("seg_softmax", mask, e=e)
    out = torch.empty_like(e)
    if e.numel():
        _build.launch("seg_softmax", "seg_softmax_forward_launch", e, mask, out, *_dims(e))
    return out


def seg_softmax_backward_cuda(alpha: torch.Tensor, grad: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Gradient of the logits from the CUDA backward kernel."""
    _check("seg_softmax_backward", mask, alpha=alpha, grad=grad)
    if alpha.shape != grad.shape:
        raise KernelContractError("seg_softmax_backward", "alpha and grad differ in shape",
                                  {"alpha": tuple(alpha.shape), "grad": tuple(grad.shape)})
    out = torch.empty_like(alpha)
    if alpha.numel():
        _build.launch("seg_softmax", "seg_softmax_backward_launch", alpha, grad, mask, out,
                      *_dims(alpha), counter="seg_softmax_backward")
    return out


def _on_cpu(t: torch.Tensor, kernel: str) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise KernelContractError(kernel, f"unsupported device {t.device}")
    return t.device.type == "cpu"


class _SegSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, mask):
        if _on_cpu(e, "seg_softmax"):
            alpha = seg_softmax_ref(e, mask)
        else:
            alpha = seg_softmax_cuda(_aligned(e), mask.contiguous())
        ctx.save_for_backward(alpha, mask)
        return alpha

    @staticmethod
    def backward(ctx, grad):
        alpha, mask = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        if _on_cpu(grad, "seg_softmax_backward"):
            return seg_softmax_backward_ref(alpha, grad, mask), None
        return seg_softmax_backward_cuda(alpha, _aligned(grad), mask.contiguous()), None


def seg_softmax(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the neighbor slots (dim 1) of ``(n, w)`` or
    ``(n, w, h)`` logits; masked slots and all-masked rows give 0."""
    return _SegSoftmax.apply(e, mask)
