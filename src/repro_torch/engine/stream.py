"""Streaming plan iterator with prefetch (port of ``repro.engine.stream``).

The stream builds the items of the next ``prefetch`` steps before the
consumer gets the current one, in step order: plan, seed rows, RNG and,
with ``fetch_features=True``, the plan's input-layer features through
the engine's store (so a tiered store's CLOCK state advances in step
order, whatever the depth).  The items are the same at every depth.

The port builds plans eagerly and the build is host-bound (the RNG's
variates and the per-PE loop), so a deeper prefetch moves work earlier
but overlaps nothing yet: no host thread runs here.  Overlap waits for
the plan build on the card (ROADMAP A6).
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


@dataclass(frozen=True)
class StreamItem:
    """One pipeline step: the plan plus the RNG that sampled it."""

    step: int
    plan: "Plan"
    rng: "DependentRNG"
    seeds: np.ndarray  # (P, b) host seed rows
    features: Optional[torch.Tensor] = None  # input-layer H when fetched


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
        plan = eng.plan_at(step)
        seeds = eng.seed_batch(step)
        rng = eng.rng_at(step)
        feats = eng.gather_features(plan) if self.fetch_features else None
        return StreamItem(step=step, plan=plan, rng=rng, seeds=seeds, features=feats)

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
