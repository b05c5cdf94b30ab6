"""Live ego-network request traffic: arrival traces + the FIFO queue.

A numpy copy of ``repro.serve.queue``.  A *request* is one user's
ego-network query -- a seed vertex to be scored by the GNN -- with an
arrival timestamp and a latency deadline (SLO).  Traces come from seeded
numpy generators (the same draws as the JAX package): Poisson arrivals
or bursty compound-Poisson ones, with Zipf-skewed seeds.

Time is *virtual* (seconds since trace start); the server advances its
own clock as it serves batches.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    """One ego-network query: score ``seed`` under the server's fanout spec."""

    rid: int                # unique, ordered by arrival
    seed: int               # seed vertex id (e.g. a user in RecsysDataset)
    t_arrival: float        # virtual seconds since trace start
    deadline_ms: float      # latency SLO for this request


def _draw_seeds(
    rng: np.random.Generator, num: int, seed_pool, zipf_a: float
) -> np.ndarray:
    """Zipf-skewed draw over a permuted ranking of ``seed_pool``."""
    pool = np.asarray(seed_pool)
    ranked = rng.permutation(len(pool))
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64) ** (-zipf_a)
    p = ranks / ranks.sum()
    return pool[ranked[rng.choice(len(pool), size=num, p=p)]]


def poisson_trace(
    num_requests: int,
    rate_rps: float,
    seed_pool,
    zipf_a: float = 1.1,
    deadline_ms: float = 50.0,
    seed: int = 0,
) -> list[Request]:
    """Poisson arrivals at ``rate_rps`` requests per virtual second."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, num_requests)
    times = np.cumsum(gaps)
    seeds = _draw_seeds(rng, num_requests, seed_pool, zipf_a)
    return [
        Request(rid=i, seed=int(seeds[i]), t_arrival=float(times[i]),
                deadline_ms=deadline_ms)
        for i in range(num_requests)
    ]


def bursty_trace(
    num_requests: int,
    rate_rps: float,
    seed_pool,
    mean_burst: float = 4.0,
    zipf_a: float = 1.1,
    deadline_ms: float = 50.0,
    seed: int = 0,
) -> list[Request]:
    """Compound-Poisson arrivals: geometric bursts at Poisson epochs.

    Burst epochs arrive at ``rate_rps / mean_burst`` so the mean offered
    load matches :func:`poisson_trace` at the same ``rate_rps``; every
    request in a burst shares the epoch timestamp.
    """
    if mean_burst < 1:
        raise ValueError("mean_burst must be >= 1")
    rng = np.random.default_rng(seed)
    times = []
    t = 0.0
    epoch_rate = rate_rps / mean_burst
    while len(times) < num_requests:
        t += float(rng.exponential(1.0 / epoch_rate))
        size = int(rng.geometric(1.0 / mean_burst))
        times.extend([t] * min(size, num_requests - len(times)))
    seeds = _draw_seeds(rng, num_requests, seed_pool, zipf_a)
    return [
        Request(rid=i, seed=int(seeds[i]), t_arrival=times[i],
                deadline_ms=deadline_ms)
        for i in range(num_requests)
    ]


def make_trace(kind: str, *args, **kwargs) -> list[Request]:
    """Factory: ``"poisson"`` | ``"bursty"``."""
    if kind == "poisson":
        return poisson_trace(*args, **kwargs)
    if kind == "bursty":
        return bursty_trace(*args, **kwargs)
    raise ValueError(f"unknown arrival process {kind!r}")


class RequestQueue:
    """FIFO view over a finite arrival trace.

    The trace is known up front (closed-loop simulation), so admission
    policies may look at *future* arrival times (e.g. "when does the
    B-th next request land?") — the virtual-clock equivalent of blocking
    on the request socket until the batch fills.
    """

    def __init__(self, trace: list[Request]):
        self._trace = sorted(trace, key=lambda r: (r.t_arrival, r.rid))
        self._i = 0

    def __len__(self) -> int:
        return len(self._trace) - self._i

    @property
    def pending(self) -> bool:
        return self._i < len(self._trace)

    def peek_time(self) -> float:
        """Arrival time of the oldest undelivered request."""
        if not self.pending:
            raise IndexError("queue exhausted")
        return self._trace[self._i].t_arrival

    def arrival_time(self, k: int) -> float:
        """Arrival time of the k-th next pending request (0-indexed)."""
        if self._i + k >= len(self._trace):
            raise IndexError(f"only {len(self)} requests pending")
        return self._trace[self._i + k].t_arrival

    def take(self, n: int) -> list[Request]:
        """Pop the ``n`` oldest pending requests (FIFO)."""
        n = min(n, len(self))
        out = self._trace[self._i : self._i + n]
        self._i += n
        return out

    def take_until(self, t: float, limit: int) -> list[Request]:
        """Pop the oldest requests with ``t_arrival <= t``, at most ``limit``."""
        out = []
        while self.pending and len(out) < limit and self.peek_time() <= t:
            out.append(self._trace[self._i])
            self._i += 1
        return out
