"""Dependent consecutive minibatches (§3.2 + A.7), port of ``repro.core.dependent``.

Two constructions from the paper:

* **Nested** (§3.2): sample one kappa*b-sized batch, then carve kappa
  b-sized minibatches out of it.  Input features of all kappa batches are
  a subset of the big batch's S^L.
* **Smoothed** (A.7, preferred): keep plain b-sized batches but draw
  sampler variates from :class:`DependentRNG`, which interpolates between
  RNG seeds with period kappa.

This module provides the schedulers; the RNG math lives in
:mod:`repro_torch.core.rng`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.rng import DependentRNG


@dataclass(frozen=True)
class DependentSchedule:
    """Produces the rng stream for smoothed dependency."""

    base_seed: int
    kappa: Optional[int]  # None = infinite dependency

    def rng_at(self, step: int) -> DependentRNG:
        return DependentRNG(self.base_seed, self.kappa, step)


@dataclass
class NestedSchedule:
    """Nested dependent minibatching (§3.2): kappa sub-batches per group.

    ``sub_batch(step, group_ids)`` partitions the kappa*b group batch into
    kappa disjoint b-sized sub-batches, reshuffled per group.
    """

    base_seed: int
    kappa: int
    sub_batch_size: int

    def group_index(self, step: int) -> int:
        return step // self.kappa

    def sub_batch(self, step: int, group_ids: np.ndarray) -> np.ndarray:
        g, i = divmod(step, self.kappa)
        order = np.random.default_rng(self.base_seed + 31 * g).permutation(
            len(group_ids)
        )
        sel = order[i * self.sub_batch_size : (i + 1) * self.sub_batch_size]
        return np.asarray(group_ids)[sel]

    def rng_for_group(self, step: int) -> DependentRNG:
        # one frozen RNG per group: all sub-batches share neighborhoods
        return DependentRNG(self.base_seed + self.group_index(step), None, 0)
