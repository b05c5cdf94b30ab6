"""Streaming plan iterator with prefetch (port of ``repro.engine.stream``).

The stream dispatches the items of the next ``prefetch`` steps before the
consumer gets the current one, in step order: plan, seed rows, RNG and,
with ``fetch_features=True``, the plan's input-layer features through
the engine's store (so a tiered store's CLOCK state advances in step
order, whatever the depth).  The items are the same at every depth.

A dispatch does not wait for the device: on a card the plan is one
replay of the engine's captured ``plan_at`` program, and the seed rows
go to pinned host memory by an asynchronous copy that
:attr:`StreamItem.seeds` waits for on first access.  So the host runs
ahead and the card builds the next plans while the consumer works, as
the JAX package's asynchronous dispatch does.  A feature fetch through
the tiered store still waits for its plan (the cache's host fills need
the miss counts), so with ``fetch_features=True`` each dispatch ends in
that sync.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Optional

import numpy as np
import torch

if TYPE_CHECKING:  # import cycle guard, typing only
    from repro_torch.core.rng import DependentRNG
    from repro_torch.engine.engine import MinibatchEngine
    from repro_torch.engine.plan import Plan


class HostRows:
    """A device tensor on its way to host memory: a non-blocking copy into
    pinned memory and an event after it (on a card); :meth:`numpy` waits
    for that event only, not for later work on the stream."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            t = host
        self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()


@dataclass(frozen=True)
class StreamItem:
    """One pipeline step: the plan plus the RNG that sampled it."""

    step: int
    plan: "Plan"
    rng: "DependentRNG"
    seed_rows: HostRows  # (P, b) seed rows, copied to the host
    features: Optional[torch.Tensor] = None  # input-layer H when fetched

    @property
    def seeds(self) -> np.ndarray:
        """(P, b) host seed rows (the first access waits for their copy)."""
        return self.seed_rows.numpy()


class MinibatchStream:
    """Iterator over :class:`StreamItem`; ``prefetch`` items built ahead.

    ``prefetch=2`` builds item *i+1* before the consumer gets item *i*;
    ``prefetch=0`` (or 1) builds each item right before it is yielded.
    An early stop yields exactly the prefix of the full run.
    """

    def __init__(
        self,
        engine: "MinibatchEngine",
        num_steps: int,
        start_step: int = 0,
        prefetch: int = 2,
        fetch_features: bool = False,
    ):
        if num_steps < 0 or prefetch < 0:
            raise ValueError("num_steps and prefetch must be >= 0")
        self.engine = engine
        self.num_steps = num_steps
        self.start_step = start_step
        self.prefetch = prefetch
        self.fetch_features = fetch_features

    def _make(self, step: int) -> StreamItem:
        eng = self.engine
        plan, seeds = eng.plan_and_seeds(step)
        feats = eng.gather_features(plan) if self.fetch_features else None
        return StreamItem(step=step, plan=plan, rng=eng.rng_at(step),
                          seed_rows=HostRows(seeds), features=feats)

    def __len__(self) -> int:
        return self.num_steps

    def __iter__(self) -> Iterator[StreamItem]:
        buf: deque[StreamItem] = deque()
        depth = max(1, self.prefetch)
        for step in range(self.start_step, self.start_step + self.num_steps):
            buf.append(self._make(step))
            if len(buf) >= depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
