from repro_torch.kernels.unique_compact.ops import (
    unique_compact,
    unique_compact_cuda,
    unique_with_inverse,
)
from repro_torch.kernels.unique_compact.ref import (
    unique_compact_sorted_ref,
    unique_with_inverse_ref,
)

__all__ = [
    "unique_compact", "unique_compact_cuda", "unique_with_inverse",
    "unique_compact_sorted_ref", "unique_with_inverse_ref",
]
