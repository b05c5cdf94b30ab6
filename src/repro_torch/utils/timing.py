"""Wall-clock timing helpers (port of ``repro.utils.timing``)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Timer:
    """Accumulating timer; use as a context manager around hot regions."""

    name: str = "timer"
    total_s: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total_s += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean_us(self) -> float:
        return 1e6 * self.total_s / max(1, self.count)

    def reset(self) -> None:
        self.total_s = 0.0
        self.count = 0


def _wait(out) -> None:
    """Wait for the device work behind ``out``: ``torch.cuda.synchronize``
    when any tensor in it (a tensor, or a tuple, list or dict of them) is
    on a CUDA device; CPU results are ready when returned."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _wait(x)
    elif isinstance(out, dict):
        for x in out.values():
            _wait(x)


def bench_fn(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Return mean host microseconds per call of ``fn(*args)``, the device
    work of CUDA outputs included (synchronised before each clock read)."""
    for _ in range(warmup):
        _wait(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait(out)
    return 1e6 * (time.perf_counter() - t0) / iters
