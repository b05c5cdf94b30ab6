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

As the JAX package jits ``clock_access`` and ``_assemble``, steps 1-2 and
step 4 are two :class:`repro_torch.engine.compiled.CompiledFunction`
programs of fixed shape, keyed by the caller's key (a serving bucket, a
stream's ``(P, n)``): on a card captured CUDA graphs that update the
CLOCK state and the cache rows in place.  Step 3 stays on the host
between them, as in the reference: one read of the missed ids (the one
sync of a gather), the host gather into pinned memory and one upload of
those rows.  The second program expands them into the reference's dense
``fetched`` block, aligned with the unique ids (zeros at hits and
padding).

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

from repro_torch.core.graph import INVALID
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gather import gather
from repro_torch.store.clock import ClockAccess, ClockState, clock_access, clock_init, unique_rows


def _assemble(
    rows: torch.Tensor, acc: ClockAccess, fetched: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """Combine cache hits + host fetches into the output; admit fetches.

    ``rows``: the ``(P * slots + 1, d)`` cache rows, PE-major, updated in
    place; the last is a spare row that dropped admissions write to.
    ``fetched``: (P, n, d) host rows aligned with ``acc.uniq`` (zeros at
    hits and padding).  Returns the gathered (P, n_ids, d) output, as the
    JAX package's ``_assemble`` does.
    """
    P, n = acc.uniq.shape
    slots = (rows.shape[0] - 1) // P
    dev = rows.device
    pe = torch.arange(P, device=dev)[:, None]
    # read hit rows BEFORE admitting this batch's fetches: a slot being
    # recycled in this batch must serve its lookup-time value
    cached = rows[(pe * slots + acc.slot.clamp(min=0)).reshape(-1)].reshape(P, n, -1)
    uniq_rows = torch.where(acc.hit[..., None], cached, fetched)
    tgt = torch.where(acc.fill_slot >= 0, pe * slots + acc.fill_slot, P * slots)
    rows.index_copy_(0, tgt.reshape(-1), fetched.reshape(P * n, -1))
    # route every original id (duplicates included) to its unique row
    pos = torch.searchsorted(acc.uniq, ids).clamp(max=n - 1)
    src = torch.where(ids != INVALID, pe * n + pos, -1).to(torch.int32)
    return gather(uniq_rows.reshape(P * n, -1), src)


class TieredFeatureStore:
    """Device CLOCK cache (tier 0) in front of a host feature table (tier 1).

    Same masking semantics as ``FeatureStore.gather`` (INVALID rows come
    back as zeros), bit-exact rows, plus hit/miss/fetch accounting.
    ``capacity`` and the cache state are *per PE*.  Runs on CUDA unless
    ``device="cpu"``; on a card its two programs are captured graphs.
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
        cuda = self.device.type == "cuda"
        self.host = host.pin_memory() if cuda else host
        self.capacity = capacity
        self.ways = ways
        self.num_pes = num_pes
        self.state: ClockState = clock_init(capacity, ways, num_pes, self.device)
        d = self.host.shape[1]
        self._rows = torch.zeros((num_pes * capacity + 1, d), dtype=self.host.dtype,
                                 device=self.device)
        self.data = self._rows[:-1].view(num_pes, capacity, d)  # (P, slots, d) cache rows
        self.fetched_rows = 0  # rows pulled across the host->device link
        self.batches = 0
        self._staging: dict = {}  # key -> (device rows, host rows) of the fills
        from repro_torch.engine.compiled import CompiledFunction  # the engine imports this

        pool = torch.cuda.graph_pool_handle() if cuda else None
        self.access_program = CompiledFunction(
            "store.clock_access", self._access, capture=cuda, pool=pool, state_args=(0,))
        self.assemble_program = CompiledFunction(
            "store.assemble", self._fill_assemble, capture=cuda, pool=pool,
            state_args=(0, 1))

    # -- the two programs ------------------------------------------------------
    @staticmethod
    def _access(state: ClockState, ids: torch.Tensor):
        """Dedup, probe and CLOCK-update (``state`` in place); returns the
        access and the missed unique ids (-1 elsewhere)."""
        new, acc = clock_access(state, unique_rows(ids))
        for dst, src in zip(state, new):
            dst.copy_(src)
        missed = (acc.uniq != INVALID) & ~acc.hit
        return acc, torch.where(missed, acc.uniq, -1)

    @staticmethod
    def _fill_assemble(rows: torch.Tensor, staging: torch.Tensor, acc: ClockAccess,
                       ids: torch.Tensor) -> torch.Tensor:
        """The dense ``fetched`` block from the uploaded rows (``staging``
        holds the missed unique ids' rows in row-major order), then
        :func:`_assemble`."""
        P, n = acc.uniq.shape
        missed = ((acc.uniq != INVALID) & ~acc.hit).reshape(-1)
        row_of = torch.cumsum(missed, 0, dtype=torch.int32) - 1
        fetched = gather(staging, torch.where(missed, row_of, -1)).reshape(P, n, -1)
        return _assemble(rows, acc, fetched, ids)

    def gather(self, ids, key=None) -> torch.Tensor:
        """Masked gather through the cache; INVALID rows come back zero.

        ``key`` names the programs' key (a serving bucket; default the ids'
        shape).  Between the two programs the missed ids are read on the
        host (the one sync), their rows gathered from host memory and
        uploaded."""
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
        key = tuple(ids.shape) if key is None else key
        acc, miss = self.access_program(key, self.state, ids)

        # slow tier: fetch only the missed unique rows from host memory
        staging, host_rows = self._staging_for(key, ids.numel())
        miss = miss.reshape(-1).cpu().numpy()  # the one sync: the missed ids' read
        miss = torch.from_numpy(miss[miss >= 0].astype(np.int64))
        k = int(miss.shape[0])
        torch.index_select(self.host, 0, miss, out=host_rows[:k])
        if staging is not host_rows:
            staging[:k].copy_(host_rows[:k], non_blocking=True)
        self.fetched_rows += k
        self.batches += 1

        out = self.assemble_program(key, self._rows, staging, acc, ids)
        return out[0] if squeeze else out

    def _staging_for(self, key, n: int) -> tuple:
        """The device rows the fills of ``key`` upload into and their host
        rows (pinned on a card; the same tensor on the CPU)."""
        if key not in self._staging:
            shape, dt = (n, self.host.shape[1]), self.host.dtype
            host = torch.empty(shape, dtype=dt, pin_memory=self.device.type == "cuda")
            dev = torch.zeros(shape, dtype=dt, device=self.device) if self.device.type == "cuda" else host
            self._staging[key] = (dev, host)
        return self._staging[key]

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

    def clear(self) -> None:
        """Empty the cache and zero its counters in place: the state of a
        new store, with this one's programs kept."""
        fresh = clock_init(self.capacity, self.ways, self.num_pes, self.device)
        for dst, src in zip(self.state, fresh):
            dst.copy_(src)
        self._rows.zero_()
        self.fetched_rows = 0
        self.batches = 0

    def reset_stats(self) -> None:
        """Zero the CLOCK counters, ``fetched_rows`` and ``batches`` in place;
        the cache's contents stay."""
        for t in (self.state.hits, self.state.misses, self.state.requested):
            t.zero_()
        self.fetched_rows = 0
        self.batches = 0
