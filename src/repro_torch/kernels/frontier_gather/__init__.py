from repro_torch.kernels.frontier_gather.ops import frontier_gather, frontier_gather_cuda
from repro_torch.kernels.frontier_gather.ref import frontier_gather_ref

__all__ = ["frontier_gather", "frontier_gather_cuda", "frontier_gather_ref"]
