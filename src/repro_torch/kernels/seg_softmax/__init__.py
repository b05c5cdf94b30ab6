from repro_torch.kernels.seg_softmax.ops import (
    seg_softmax,
    seg_softmax_backward_cuda,
    seg_softmax_cuda,
)
from repro_torch.kernels.seg_softmax.ref import (
    seg_softmax_backward_ref,
    seg_softmax_ref,
    warp_sum,
)

__all__ = [
    "seg_softmax", "seg_softmax_backward_cuda", "seg_softmax_backward_ref",
    "seg_softmax_cuda", "seg_softmax_ref", "warp_sum",
]
