"""Coalescing: admission policies, the bucket ladder, and the merger.

Port of ``repro.serve.coalesce``.  The sampled subgraph of a merged seed
set is smaller than the union of per-request subgraphs, so waiting a
little to batch requests buys bandwidth and compute.  Three admission
policies trade that gain against queueing delay:

* ``max_batch``  -- dispatch as soon as B requests are waiting;
* ``max_wait_ms`` -- dispatch when the oldest waiting request has aged w ms;
* ``hybrid``     -- whichever of the two fires first.

Merged seed sets are padded to a static *bucket ladder*, so plan shapes
and compiled programs come in a few sizes only.  :class:`BucketGuard` is
the counterpart of the JAX package's ``BucketedJit``: one program per
bucket of a serving step (a captured CUDA graph on a card with the fused
plan backend, :mod:`repro_torch.engine.compiled`), ``compiles`` per
bucket, and :class:`RetraceError` when a bucket sees a second shape.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.graph import INVALID
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import EngineConfig, MinibatchEngine
from repro_torch.engine.compiled import CompiledFunction, RetraceError
from repro_torch.serve.queue import Request, RequestQueue


# --------------------------------------------------------------------------
# bucket ladder
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class BucketLadder:
    """Sorted static seed-capacity buckets (the plan shapes a server uses)."""

    buckets: tuple[int, ...]

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(
                f"buckets must be sorted unique, got {self.buckets}"
            )
        if self.buckets[0] < 1:
            raise ValueError("bucket sizes must be >= 1")

    @classmethod
    def geometric(cls, max_batch: int, min_bucket: int = 8) -> "BucketLadder":
        """Doubling ladder ``min_bucket, 2*min_bucket, ..., >= max_batch``."""
        buckets = [min_bucket]
        while buckets[-1] < max_batch:
            buckets.append(buckets[-1] * 2)
        return cls(tuple(buckets))

    @property
    def cap(self) -> int:
        """Largest bucket — the admission cap for any single batch."""
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` seeds."""
        if n > self.cap:
            raise ValueError(f"{n} seeds exceed the ladder cap {self.cap}")
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError  # unreachable: n <= self.cap == buckets[-1]


# --------------------------------------------------------------------------
# admission policies
# --------------------------------------------------------------------------
class MaxBatchPolicy:
    """Dispatch as soon as ``max_batch`` requests are waiting.

    With fewer than ``max_batch`` requests left in the whole trace, the
    remainder flushes at the final arrival (a real server would flush on
    stream close).
    """

    name = "max_batch"

    def __init__(self, max_batch: int):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch

    def admit(self, queue: RequestQueue, now: float):
        n = len(queue)
        if n >= self.max_batch:
            t = max(now, queue.arrival_time(self.max_batch - 1))
            return queue.take(self.max_batch), t
        t = max(now, queue.arrival_time(n - 1))
        return queue.take(n), t


class MaxWaitPolicy:
    """Dispatch when the oldest waiting request has aged ``max_wait_ms``.

    Everything that arrived by the close time rides along, capped at the
    ladder's largest bucket (``cap`` is stamped by the server).
    """

    name = "max_wait_ms"

    def __init__(self, max_wait_ms: float, cap: int = 1 << 30):
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.max_wait_ms = max_wait_ms
        self.cap = cap

    def admit(self, queue: RequestQueue, now: float):
        t_first = queue.peek_time()
        t_close = max(now, t_first + self.max_wait_ms / 1e3)
        reqs = queue.take_until(t_close, self.cap)
        return reqs, t_close


class HybridPolicy:
    """Dispatch at whichever fires first: batch full or oldest aged out."""

    name = "hybrid"

    def __init__(self, max_batch: int, max_wait_ms: float):
        if max_batch < 1 or max_wait_ms < 0:
            raise ValueError("need max_batch >= 1 and max_wait_ms >= 0")
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms

    def admit(self, queue: RequestQueue, now: float):
        t_first = queue.peek_time()
        t_wait = max(now, t_first + self.max_wait_ms / 1e3)
        if len(queue) >= self.max_batch:
            t_full = max(now, queue.arrival_time(self.max_batch - 1))
            if t_full <= t_wait:
                return queue.take(self.max_batch), t_full
        reqs = queue.take_until(t_wait, self.max_batch)
        return reqs, t_wait


POLICIES = ("max_batch", "max_wait_ms", "hybrid")


def make_policy(name: str, max_batch: int, max_wait_ms: float):
    """Factory over :data:`POLICIES`; ``max_batch`` doubles as the cap."""
    if name == "max_batch":
        return MaxBatchPolicy(max_batch)
    if name == "max_wait_ms":
        return MaxWaitPolicy(max_wait_ms, cap=max_batch)
    if name == "hybrid":
        return HybridPolicy(max_batch, max_wait_ms)
    raise ValueError(f"unknown admission policy {name!r}; one of {POLICIES}")


# --------------------------------------------------------------------------
# retrace guard
# --------------------------------------------------------------------------
#: The port's ``BucketedJit``: one program per bucket of a serving step
#: (a captured CUDA graph when ``capture``), ``compiles`` per bucket, and
#: :class:`RetraceError` when a bucket sees a second shape signature.
BucketGuard = CompiledFunction


# --------------------------------------------------------------------------
# the coalescer
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class CoalescedBatch:
    """One admitted batch: its requests and the padded, deduplicated seeds."""

    requests: tuple[Request, ...]
    seeds: np.ndarray          # (bucket,) int32, sorted unique + INVALID pad
    bucket: int
    t_dispatch: float

    @property
    def num_unique(self) -> int:
        return int((self.seeds != INVALID).sum())


class Coalescer:
    """Merges admitted requests into one shared minibatch plan.

    Seeds dedup into a sorted set, pad to the smallest ladder bucket,
    and build through ``MinibatchEngine.build_plan`` — one lazily
    constructed engine per bucket (static capacities scale with the
    bucket), all sharing the server's graph, sampler spec, and RNG seed
    so a vertex's sampled ego-network is bit-identical across buckets,
    policies, and batch compositions (hash-keyed per-vertex sampling).
    """

    def __init__(
        self,
        graph,
        base_config: EngineConfig,
        ladder: BucketLadder,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.ladder = ladder
        self.base_config = replace(
            base_config, mode="independent", num_pes=1, schedule="iid",
        )
        # one engine per bucket: capacities are fixed per bucket
        self._engines = {
            b: MinibatchEngine.from_config(
                graph, replace(self.base_config, local_batch=b),
                device=self.device,
            )
            for b in ladder.buckets
        }

    def engine_for(self, bucket: int) -> MinibatchEngine:
        return self._engines[bucket]

    def coalesce(
        self, requests: list[Request], t_dispatch: float
    ) -> CoalescedBatch:
        if not requests:
            raise ValueError("cannot coalesce an empty request set")
        uniq = np.unique(
            np.asarray([r.seed for r in requests], np.int32)
        )
        bucket = self.ladder.bucket_for(len(uniq))
        seeds = np.full((bucket,), INVALID, np.int32)
        seeds[: len(uniq)] = uniq
        return CoalescedBatch(
            requests=tuple(requests), seeds=seeds, bucket=bucket,
            t_dispatch=t_dispatch,
        )

    def build_plan(self, batch: CoalescedBatch):
        """Plan for one coalesced batch (the server's own path)."""
        eng = self.engine_for(batch.bucket)
        return eng.build_plan(batch.seeds, step=0)
