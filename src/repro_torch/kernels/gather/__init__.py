from repro_torch.kernels.gather.ops import gather, gather_cuda
from repro_torch.kernels.gather.ref import gather_ref

__all__ = ["gather", "gather_cuda", "gather_ref"]
