"""Tiered feature store: device CLOCK cache over a host-memory tier
(port of ``repro.store.tiers``).

The full feature table stays in host memory (pinned when the cache lives
on a CUDA device, so the misses copy asynchronously) and the hot path is
served from a device-resident CLOCK cache (:mod:`repro_torch.store.clock`):

    gather(ids):
      1. dedup ids per PE (device),
      2. probe + CLOCK-update the cache (device, the tag_probe kernel),
      3. fetch only the *missed* unique rows from the host tier,
      4. assemble the output from cache hits + fresh fetches and admit
         the fetched rows into their slots (device).

Hit rows are read out of the cache data array *before* the new rows are
written, so a slot recycled within the same batch still serves the value
it held at lookup time -- output is bit-exact with the uncached
``FeatureStore.gather``.  The cache data array is updated in place.

Accounting matches the JAX package: ``requested`` counts unique valid ids
per PE-batch, ``hits + misses == requested``, and ``fetched_rows`` counts
the rows that crossed the host->device link.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.graph import INVALID
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.clock import ClockAccess, ClockState, clock_access, clock_init, unique_rows


def _assemble(
    data: torch.Tensor, acc: ClockAccess, rows: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """Combine cache hits + host fetches into the output; admit fetches.

    ``data``: (P, slots, d) cache rows, updated in place.  ``rows``: (k, d)
    host rows of the missed unique ids, in the row-major order of the
    missed entries of ``acc.uniq``.  Returns the gathered (P, n_ids, d)
    output: zeros, then each valid id's row copied in (a hit's from the
    cache, a miss's from ``rows``).
    """
    P, n = acc.uniq.shape
    dev = data.device
    valid = ids != INVALID
    # every valid id's position among its PE's unique ids (duplicates too)
    pos = torch.searchsorted(acc.uniq, ids).clamp(max=n - 1)
    missed = (acc.uniq != INVALID) & ~acc.hit
    row_of = torch.full((P, n), -1, dtype=torch.int64, device=dev)
    row_of[missed] = torch.arange(rows.shape[0], device=dev)
    out = torch.zeros((P, ids.shape[1], data.shape[2]), dtype=data.dtype, device=dev)
    # read hit rows BEFORE admitting this batch's fetches: a slot being
    # recycled in this batch must serve its lookup-time value
    hit = valid & torch.gather(acc.hit, 1, pos)
    p, j = hit.nonzero(as_tuple=True)
    out[p, j] = data[p, torch.gather(acc.slot, 1, pos)[p, j].long()]
    p, j = (valid & ~hit).nonzero(as_tuple=True)
    out[p, j] = rows[row_of[p, pos[p, j]]]
    p, j = (acc.fill_slot >= 0).nonzero(as_tuple=True)  # dropped rows are not admitted
    data[p, acc.fill_slot[p, j].long()] = rows[row_of[p, j]]
    return out


class TieredFeatureStore:
    """Device CLOCK cache (tier 0) in front of a host feature table (tier 1).

    Same masking semantics as ``FeatureStore.gather`` (INVALID rows come
    back as zeros), bit-exact rows, plus hit/miss/fetch accounting.
    ``capacity`` and the cache state are *per PE*.  Runs on CUDA unless
    ``device="cpu"``.
    """

    def __init__(
        self,
        features,
        capacity: int,
        ways: int = 8,
        num_pes: int = 1,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        host = torch.as_tensor(np.ascontiguousarray(features))
        if host.ndim != 2:
            raise ValueError(f"features must be (V, d), got {tuple(host.shape)}")
        self.host = host.pin_memory() if self.device.type == "cuda" else host
        self.capacity = capacity
        self.ways = ways
        self.num_pes = num_pes
        self.state: ClockState = clock_init(capacity, ways, num_pes, self.device)
        d = self.host.shape[1]
        self.data = torch.zeros((num_pes, capacity, d), dtype=self.host.dtype,
                                device=self.device)
        self.fetched_rows = 0  # rows pulled across the host->device link
        self.batches = 0

    def gather(self, ids) -> torch.Tensor:
        """Masked gather through the cache; INVALID rows come back zero."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids, np.int32))
        ids = ids.to(device=self.device, dtype=torch.int32)
        squeeze = ids.ndim == 1
        if squeeze:
            ids = ids[None]
        if ids.ndim != 2 or ids.shape[0] != self.num_pes:
            raise ValueError(
                f"expected ({self.num_pes}, n) ids, got shape {tuple(ids.shape)}"
            )
        with record_function("store.clock_access"):
            self.state, acc = clock_access(self.state, unique_rows(ids))

        # slow tier: fetch only the missed unique rows from host memory
        missed = (acc.uniq != INVALID) & ~acc.hit
        miss_ids = acc.uniq[missed].long().cpu()
        rows = self.host[miss_ids.clamp(0, self.host.shape[0] - 1)]
        if self.device.type == "cuda":
            rows = rows.pin_memory()
        rows = rows.to(self.device, non_blocking=True)
        self.fetched_rows += int(miss_ids.shape[0])
        self.batches += 1

        out = _assemble(self.data, acc, rows, ids)
        return out[0] if squeeze else out

    @property
    def hits(self) -> int:
        return int(self.state.hits.sum())

    @property
    def misses(self) -> int:
        return int(self.state.misses.sum())

    @property
    def requested(self) -> int:
        """Unique valid ids requested -- ``FeatureStore.count_fetched`` sums."""
        return int(self.state.requested.sum())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def miss_rate(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else 0.0

    def reset_stats(self) -> None:
        """Zero the CLOCK counters, ``fetched_rows`` and ``batches``; the
        cache's contents stay."""
        z = torch.zeros((self.num_pes,), dtype=torch.int32, device=self.device)
        self.state = self.state._replace(hits=z, misses=z, requested=z)
        self.fetched_rows = 0
        self.batches = 0
