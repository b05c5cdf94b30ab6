"""Timing and logging helpers of the port (``repro_torch.utils``)."""
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer, bench_fn

__all__ = ["Timer", "bench_fn", "get_logger"]
