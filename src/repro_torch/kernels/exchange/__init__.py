from repro_torch.kernels.exchange.ops import (
    exchange_backward_cuda,
    exchange_forward_cuda,
    exchange_rows,
    exchange_tables,
    exchange_tables_cuda,
)
from repro_torch.kernels.exchange.ref import (
    exchange_backward_ref,
    exchange_forward_ref,
    exchange_tables_ref,
)

__all__ = [
    "exchange_backward_cuda", "exchange_backward_ref", "exchange_forward_cuda",
    "exchange_forward_ref", "exchange_rows", "exchange_tables", "exchange_tables_cuda",
    "exchange_tables_ref",
]
