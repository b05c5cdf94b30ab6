from repro_torch.kernels.expand_indptr.ops import expand_indptr, expand_indptr_cuda
from repro_torch.kernels.expand_indptr.ref import expand_indptr_ref

__all__ = ["expand_indptr", "expand_indptr_cuda", "expand_indptr_ref"]
