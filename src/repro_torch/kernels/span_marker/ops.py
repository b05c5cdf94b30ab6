"""Public wrapper for the span marker.

A CPU accumulator takes the plain version (:mod:`.ref`, the host clock); a
CUDA one launches the marker kernel of the span (``span_marker.cu``, one
thread reading ``%globaltimer``) on the current stream, or raises.  The
kernel list must match :data:`repro_torch.utils.spans.SPANS`, in order;
the first launch checks the count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError
from repro_torch.kernels.span_marker.ref import span_marker_ref

_checked: list = []


def span_marker_cuda(acc: torch.Tensor, index: int, end: bool, num_spans: int) -> None:
    """Stamps span ``index`` of ``num_spans`` into the int64 CUDA buffer ``acc``."""
    _build.require_cuda("span_marker", torch.int64, acc=acc)
    if not 0 <= index < num_spans or acc.numel() < 3 * num_spans:
        raise KernelContractError("span_marker", "span index or buffer out of range",
                                  {"index": index, "spans": num_spans, "acc": acc.numel()})
    if not _checked:
        have = _build.call_int("span_marker", "span_marker_count")
        if have != num_spans:
            raise KernelContractError("span_marker", "the kernel list and SPANS differ",
                                      {"kernels": have, "spans": num_spans})
        _checked.append(have)
    _build.launch("span_marker", "span_marker_launch", acc, index, int(end))


def span_marker(acc: torch.Tensor, index: int, end: bool, num_spans: int) -> None:
    """Begin or end span ``index``: the host clock on the CPU, the device's
    global timer on a card."""
    if acc.device.type == "cpu":
        span_marker_ref(acc, index, end)
    elif acc.device.type == "cuda":
        span_marker_cuda(acc, index, end, num_spans)
    else:
        raise KernelContractError("span_marker", f"unsupported device {acc.device}")
