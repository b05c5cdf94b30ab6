"""Device-resident set-associative CLOCK cache (port of ``repro.store.clock``).

Layout: ``capacity = num_sets * ways`` slots per PE.  A vertex id hashes
to one set (Knuth multiplicative hash); within the set, ways are managed
by a clock hand over reference bits.  A batch access:

1. dedups the batch (:func:`unique_rows`, static width),
2. probes all ids against the tag array in one launch
   (:func:`repro_torch.store.kernel.tag_probe` -- the CUDA kernel),
3. sets the reference bit of every hit,
4. inserts misses round by round (at most one insert per set per round,
   ``ways`` rounds, all of them run), each round running CLOCK victim
   selection vectorized across all sets under masks.

As in the JAX package, no shape depends on the data and nothing is read
on the host, so an access can be recorded into a CUDA graph (the tiered
store's program, :mod:`repro_torch.store.tiers`).  State tensors carry a
leading ``(P, ...)`` PE axis.  An access returns new tensors for the
changed leaves and leaves the old state untouched, so callers may keep
both.

:class:`ClockCache` replays id batches through the policy alone (no
feature rows), so its hit rate can be held against the exact LRU oracle
(:class:`repro_torch.core.cache.LRUCache`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import INVALID
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.kernel import tag_probe

_HASH_MULT = 2654435761  # Knuth multiplicative hashing


class ClockState(NamedTuple):
    """Per-PE cache state; every leaf has a leading ``(P, ...)`` axis."""

    tags: torch.Tensor       # (P, S, W) int32 resident vertex id, INVALID = empty
    ref: torch.Tensor        # (P, S, W) bool CLOCK reference bits
    hand: torch.Tensor       # (P, S) int32 clock hand per set
    hits: torch.Tensor       # (P,) int32
    misses: torch.Tensor     # (P,) int32
    requested: torch.Tensor  # (P,) int32 unique valid ids seen (count_fetched)


class ClockAccess(NamedTuple):
    """Per-unique-id outcome of one batched access."""

    uniq: torch.Tensor       # (P, n) sorted unique ids, INVALID-padded
    hit: torch.Tensor        # (P, n) bool -- resident before this batch
    slot: torch.Tensor       # (P, n) int32 flat slot of hits, -1 otherwise
    fill_slot: torch.Tensor  # (P, n) int32 slot a missed row was admitted to,
                             #         -1 if dropped (set conflict overflow)


def clock_init(
    capacity: int, ways: int = 8, num_pes: int = 1, device: DeviceLike = None
) -> ClockState:
    """Empty cache of ``capacity`` rows per PE, ``capacity % ways == 0``."""
    if ways < 1 or capacity < ways:
        raise ValueError(f"need capacity >= ways >= 1, got {capacity}/{ways}")
    if capacity % ways:
        raise ValueError(f"capacity {capacity} not a multiple of ways {ways}")
    dev = resolve_device(device)
    S, P = capacity // ways, num_pes
    z = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=dev)
    return ClockState(
        tags=torch.full((P, S, ways), INVALID, dtype=torch.int32, device=dev),
        ref=z(P, S, ways, dtype=torch.bool),
        hand=z(P, S), hits=z(P), misses=z(P), requested=z(P),
    )


def hash_set(ids: torch.Tensor, num_sets: int) -> torch.Tensor:
    """Multiplicative hash of vertex ids onto ``[0, num_sets)`` (uint32 math)."""
    from repro_torch.core.rng import _mul32, _u32

    h = _mul32(_u32(ids), _HASH_MULT) >> 8
    return (h % num_sets).to(torch.int32)


def unique_rows(ids: torch.Tensor) -> torch.Tensor:
    """Row-wise sorted unique with static width (INVALID pads sort last):
    ``jnp.unique(row, size=n, fill_value=INVALID)`` per row, through the
    plan path's sort and ``unique_compact`` (the CUDA kernel on a card),
    so the shape never depends on the data."""
    from repro_torch.kernels import unique_compact

    n = ids.shape[-1]
    return torch.stack([unique_compact(row.contiguous(), n) for row in ids])


def _insert(tags, ref, hand, ids, sets, hit, way):
    """Insert this batch's misses into every PE's cache (CLOCK eviction).

    ``ids`` holds one deduplicated row per PE; at most one insert lands
    per set per round, so ``ways`` rounds admit every miss that can fit.
    Overflowing conflicts (more misses than ways hashing to one set) are
    dropped -- they stay misses and their rows are served straight from
    the fetch.  Every round runs over all sets with masks, as the JAX
    package's static loop does, so no shape depends on the data.
    """
    P, S, W = tags.shape
    n = ids.shape[1]
    dev = ids.device
    valid = ids != INVALID
    miss = valid & ~hit

    # second chance for every hit; the rest write a spare entry
    flat = torch.arange(P, device=dev)[:, None] * (S * W) + sets.long() * W + way.clamp(min=0)
    ref = torch.cat([ref.reshape(-1), ref.new_zeros(1)])
    ref = ref.scatter_(0, torch.where(hit, flat, P * S * W).reshape(-1), True)  # a scalar fill,
    ref = ref[:-1].reshape(P, S, W)  # not an upload (illegal in a capture)

    # rank of each miss within its set: sort by set, then position since
    # the start of the equal-set run
    key = torch.where(miss, sets, S)
    skey, order = torch.sort(key, dim=1, stable=True)
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(P, n)
    newseg = torch.ones((P, n), dtype=torch.bool, device=dev)
    newseg[:, 1:] = skey[:, 1:] != skey[:, :-1]
    seg_start = torch.cummax(torch.where(newseg, idx, 0), dim=1).values
    rank = torch.empty((P, n), dtype=torch.int32, device=dev).scatter_(1, order, idx - seg_start)

    fill_slot = torch.full((P, n), -1, dtype=torch.int32, device=dev)
    wpos = torch.arange(W, dtype=torch.int32, device=dev)
    for r in range(W):
        sel = miss & (rank == r)
        # the id this round inserts into each set (at most one: ranks are
        # unique within a set), INVALID where none; the rest write a spare
        tgt = torch.where(sel, sets, S).long()
        ins = torch.full((P, S + 1), INVALID, dtype=torch.int32, device=dev)
        ins = ins.scatter_(1, tgt, ids)[:, :S]
        do = ins != INVALID                                       # (P, S)
        # CLOCK sweep, vectorized over sets: walk ways from the hand,
        # victim = first clear ref bit; if all set, clear the full circle
        # and take the hand position (classic second chance).
        ordered = (hand[..., None] + wpos) % W                    # (P, S, W)
        ref_ord = torch.gather(ref, 2, ordered.long())
        k = torch.argmin(ref_ord.to(torch.uint8), dim=2)
        swept = (wpos < k[..., None]) | ref_ord.all(2)[..., None]
        ref_ord = ref_ord & ~swept
        inv = (wpos - hand[..., None]) % W
        ref_nat = torch.gather(ref_ord, 2, inv.long())
        victim = torch.gather(ordered, 2, k[..., None])[..., 0]
        at_victim = wpos == victim[..., None]
        tags = torch.where(do[..., None] & at_victim, ins[..., None], tags)
        ref = torch.where(do[..., None], at_victim | ref_nat, ref)
        hand = torch.where(do, (victim + 1) % W, hand)
        fill_slot = torch.where(sel, sets * W + torch.gather(victim, 1, sets.long()), fill_slot)

    # a later round may have evicted an earlier same-batch insert (only
    # possible at W == 1): an admitted row owns its slot only if its tag
    # survived to the end of the batch
    survived = torch.gather(tags.reshape(P, S * W), 1, fill_slot.clamp(min=0).long()) == ids
    fill_slot = torch.where((fill_slot >= 0) & survived, fill_slot, -1)
    return tags, ref, hand, fill_slot, miss


def clock_access(state: ClockState, uniq: torch.Tensor) -> tuple[ClockState, ClockAccess]:
    """Access one deduplicated batch per PE; returns the new state.

    ``uniq``: (P, n) row-wise *unique* sorted ids (see :func:`unique_rows`),
    INVALID-padded.  Lookup resolves against the pre-batch tags: a row
    evicted by this batch's own inserts still counts as the hit it was
    when the batch arrived.  Every shape is fixed by ``uniq``'s and the
    state's, and nothing is read on the host.
    """
    P, S, W = state.tags.shape
    valid = uniq != INVALID
    sets = torch.where(valid, hash_set(uniq, S), 0)
    # one flat probe for all PEs: offset each PE's sets into a (P*S, W)
    # tag view so the kernel runs once
    offs = torch.arange(P, dtype=torch.int32, device=uniq.device)[:, None] * S
    pids = torch.where(valid, uniq, -1)  # -1 never matches a resident tag
    way = tag_probe(
        state.tags.reshape(P * S, W), (sets + offs).reshape(-1), pids.reshape(-1)
    ).reshape(P, -1)
    hit = way >= 0
    slot = torch.where(hit, sets * W + way.clamp(min=0), -1)

    tags, ref, hand, fill_slot, miss = _insert(state.tags, state.ref, state.hand, uniq, sets,
                                               hit, way)
    new = ClockState(
        tags=tags, ref=ref, hand=hand,
        hits=state.hits + hit.sum(1, dtype=torch.int32),
        misses=state.misses + miss.sum(1, dtype=torch.int32),
        requested=state.requested + valid.sum(1, dtype=torch.int32),
    )
    return new, ClockAccess(uniq=uniq, hit=hit, slot=slot, fill_slot=fill_slot)


class ClockCache:
    """Stateful replay wrapper mirroring ``LRUCache.access_batch``.

    Tracks only tags/ref/hand/counters (no feature rows) so tests and the
    chip smoke can replay id traces through the device policy and compare
    hit rates against the exact LRU oracle.  ``num_pes > 1`` mirrors
    ``CooperativeCacheArray``: row p of an access touches only PE p's
    cache.  Runs on CUDA unless ``device="cpu"``; each access there makes
    one ``tag_probe`` launch.
    """

    def __init__(self, capacity: int, ways: int = 8, num_pes: int = 1,
                 device: DeviceLike = None):
        self.capacity = capacity
        self.ways = ways
        self.num_pes = num_pes
        self.device = resolve_device(device)
        self.state = clock_init(capacity, ways, num_pes, self.device)

    def access_batch(self, ids) -> int:
        """Access the unique valid ids of one batch; returns #misses."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids, np.int32))
        ids = ids.to(device=self.device, dtype=torch.int32)
        if self.num_pes == 1:
            ids = ids.reshape(1, -1)
        elif ids.ndim != 2 or ids.shape[0] != self.num_pes:
            raise ValueError(
                f"expected (P={self.num_pes}, n) ids, got {tuple(ids.shape)}"
            )
        before = self.state.misses
        self.state, _ = clock_access(self.state, unique_rows(ids))
        return int((self.state.misses - before).sum())

    # cooperative-parity alias (CooperativeCacheArray.access)
    access = access_batch

    @property
    def hits(self) -> int:
        return int(self.state.hits.sum())

    @property
    def misses(self) -> int:
        return int(self.state.misses.sum())

    @property
    def miss_rate(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else 0.0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        z = torch.zeros((self.num_pes,), dtype=torch.int32, device=self.device)
        self.state = self.state._replace(hits=z, misses=z, requested=z)
