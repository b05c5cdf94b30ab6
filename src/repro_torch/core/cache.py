"""LRU vertex-embedding cache simulator (port of ``repro.core.cache``;
§4.2, Fig. 5).

The paper demonstrates dependent minibatching by measuring LRU-cache miss
rates for vertex-embedding fetches (miss rate ∝ storage-to-PE traffic).
True LRU is host control flow by nature (an ordered key sequence updated
one access at a time), so it runs on the host here exactly as in the JAX
package: an exact numpy simulator, the oracle that the device CLOCK
policy (:mod:`repro_torch.store.clock`) is judged against.  Ids may come
as numpy arrays or torch tensors on any device; a tensor comes to the host
once per batch.  :class:`CooperativeCacheArray` is the multi-PE variant
where each PE caches only owned vertices, which is what makes cooperative
feature loading "effectively increase the global cache size" (§4.3.1).
"""
from __future__ import annotations

import bisect
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

_INVALID = np.iinfo(np.int32).max


def _host(ids) -> np.ndarray:
    """``ids`` as a host numpy array (one device-to-host copy for a tensor)."""
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy()
    return np.asarray(ids)


@dataclass
class LRUCache:
    """Exact LRU over vertex ids; counts unique-per-batch accesses."""

    capacity: int
    hits: int = 0
    misses: int = 0
    _store: OrderedDict = field(default_factory=OrderedDict)
    # primary fast-path state: LRU-ordered key array, oldest first.
    # ``_store`` is only materialized for the sequential fallback;
    # ``_store_stale`` marks it behind ``_keys``.
    _keys: np.ndarray = field(default=None, repr=False)
    _store_stale: bool = field(default=False, repr=False)

    def access_batch(self, ids: np.ndarray) -> int:
        """Access the unique valid ids of one minibatch; returns #misses.

        Equivalent to processing the sorted unique ids one at a time
        (hit -> move to end; miss -> insert, evict LRU front), but run as
        a vectorized membership precheck — one ``searchsorted`` of the
        LRU-ordered key array into the (sorted-unique) batch — plus bulk
        array surgery, so oracle replays on large traces are not
        dominated by the per-element Python loop.

        The only subtlety is a cached key that is both in the batch and
        within eviction reach: whether it is re-hit or evicted-then-
        re-missed depends on the interleaving of its access with the
        eviction stream.  Because evictions consume original-key
        positions front-to-back (hits leave the front region; with
        ``n <= capacity`` reinserted keys are never re-evicted), each
        such *at-risk* key is resolved exactly, in access order: it is
        evicted iff the evictions issued before its access
        (``misses_so_far - free_slack``) cover every consumable position
        ahead of it plus itself.  Only batches larger than the capacity
        fall back to the sequential walk.
        """
        ids = np.unique(_host(ids).ravel().astype(np.int64))
        ids = ids[ids != _INVALID]
        n = len(ids)
        if n == 0:
            return 0
        if n > self.capacity:
            # evictions can reach keys reinserted mid-batch; rare — the
            # whole cache turns over — so exactness beats speed here
            return self._access_sequential(ids)
        if self._keys is None:
            self._keys = np.fromiter(
                self._store.keys(), dtype=np.int64, count=len(self._store)
            )
        keys = self._keys  # LRU order, oldest first
        m0 = len(keys)
        pos = np.searchsorted(ids, keys)
        touched = np.zeros(m0, bool)
        inb = pos < n
        touched[inb] = ids[pos[inb]] == keys[inb]
        member = np.zeros(n, bool)  # batch ranks present in the cache
        member[pos[touched]] = True
        base_miss = n - int(touched.sum())  # misses ignoring evictions
        # base_cum[r] = definite misses among ids[:r]
        base_cum = np.concatenate(([0], np.cumsum(~member)))
        slack = self.capacity - m0
        tp = np.flatnonzero(touched)  # touched positions, oldest first
        # Eviction-frontier upper bound F: the frontier passes f
        # positions after E evictions and S skips (f = E + S), with
        # E <= max(0, m0 + base_miss + X - capacity) and X + S =
        # touched-below-f.  So any reachable f satisfies
        # f <= g(f) = max(0, base_miss - slack + #touched<f); g grows by
        # <= 1 per position, so {f : f <= g(f)} is an interval [0, F] —
        # find F by binary search.  Touched keys at positions >= F are
        # certain hits.
        lo, hi = 0, m0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            bound = base_miss - slack + int(np.searchsorted(tp, mid))
            if mid <= max(0, bound):
                lo = mid
            else:
                hi = mid - 1
        n_risk = int(np.searchsorted(tp, lo))  # at-risk = tp[:n_risk]
        extra = 0  # evicted-then-re-missed at-risk keys so far
        evict_pos: list = []  # their positions, sorted
        if n_risk:
            ar = tp[:n_risk]
            ar_ranks = pos[ar]
            proc: list = []  # processed at-risk positions, sorted
            for oi in np.argsort(ar_ranks).tolist():
                q = int(ar[oi])
                # evictions issued before this key's access vs the
                # consumable positions the frontier must pass first:
                # every position < q except touched keys hit before the
                # frontier reached them
                issued = int(base_cum[ar_ranks[oi]]) + extra - slack
                avail = (
                    q
                    - bisect.bisect_left(proc, q)
                    + bisect.bisect_left(evict_pos, q)
                )
                if issued >= avail + 1:
                    extra += 1
                    bisect.insort(evict_pos, q)
                bisect.insort(proc, q)
        n_miss = base_miss + extra
        n_evict = max(0, m0 + n_miss - self.capacity)
        # victims: the first n_evict candidate positions (untouched or
        # evicted-at-risk); survivors keep relative order; batch ids land
        # at the end in ascending order, same as the sequential walk over
        # sorted unique ids
        keep = ~touched
        if n_evict:
            cand = keep.copy()
            if evict_pos:
                cand[evict_pos] = True
            keep[np.flatnonzero(cand)[:n_evict]] = False
        self._keys = np.concatenate([keys[keep], ids])
        self._store_stale = True
        self.hits += n - n_miss
        self.misses += n_miss
        return n_miss

    def _access_sequential(self, ids: np.ndarray) -> int:
        """Exact reference walk (sorted unique valid ids pre-applied)."""
        if self._store_stale:
            self._store = OrderedDict.fromkeys(self._keys.tolist(), True)
            self._store_stale = False
        miss_now = 0
        for v in ids.tolist():
            if v in self._store:
                self._store.move_to_end(v)
                self.hits += 1
            else:
                miss_now += 1
                self.misses += 1
                self._store[v] = True
                if len(self._store) > self.capacity:
                    self._store.popitem(last=False)
        self._keys = None  # the sequential walk reorders arbitrarily
        return miss_now

    def lru_keys(self) -> np.ndarray:
        """Resident keys in LRU order, oldest first (copy)."""
        if self._keys is None:
            self._keys = np.fromiter(
                self._store.keys(), dtype=np.int64, count=len(self._store)
            )
        return self._keys.copy()

    @property
    def miss_rate(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else 0.0

    def reset_stats(self) -> None:
        self.hits = self.misses = 0


@dataclass
class CooperativeCacheArray:
    """P per-PE LRU caches over *owned* ids (Fig. 5b setup).

    Independent minibatching: every PE caches any vertex it touches, so
    hot vertices occupy P cache slots globally.  Cooperative: vertices
    are fetched only by their owner, so the global effective capacity is
    P * capacity with zero duplication.
    """

    num_pes: int
    capacity_per_pe: int
    caches: list = field(default_factory=list)

    def __post_init__(self):
        if not self.caches:
            self.caches = [LRUCache(self.capacity_per_pe) for _ in range(self.num_pes)]

    def access(self, per_pe_ids: np.ndarray) -> int:
        """per_pe_ids: (P, n) padded id batches; returns total misses."""
        per_pe_ids = _host(per_pe_ids)
        return sum(
            self.caches[p].access_batch(per_pe_ids[p]) for p in range(self.num_pes)
        )

    @property
    def miss_rate(self) -> float:
        h = sum(c.hits for c in self.caches)
        m = sum(c.misses for c in self.caches)
        return m / (h + m) if (h + m) else 0.0

    def reset_stats(self) -> None:
        for c in self.caches:
            c.reset_stats()
