from repro_torch.kernels.spmm.ops import spmm_backward_cuda, spmm_cuda, spmm_mean, spmm_sum
from repro_torch.kernels.spmm.ref import backward_order, spmm_backward_ref, spmm_ref

__all__ = [
    "backward_order", "spmm_backward_cuda", "spmm_backward_ref", "spmm_cuda",
    "spmm_mean", "spmm_ref", "spmm_sum",
]
