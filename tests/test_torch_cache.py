"""Cache oracles and counters of the port vs the JAX package, bit for bit.

* ``LRUCache``: per-batch misses and ``lru_keys()`` after every batch of
  iid, smoothed and nested traces with INVALID padding, at capacities
  above the batch (the vectorised at-risk resolution) and below it (the
  sequential fallback); ids as numpy arrays or torch tensors.
* ``CooperativeCacheArray``: per-step misses, miss rate, ``reset_stats``.
* ``ClockCache`` (``device="cpu"``): per-batch misses and the
  ``tags``/``ref``/``hand``/counter state after every batch, at 1 and 4
  PEs; the shape error; ``reset_stats``.
* ``TieredFeatureStore.miss_rate`` / ``reset_stats`` and
  ``FeatureStore.count_duplicates_across_pes``.
* The κ sweep of ``tests/test_dependent_cache.py``: the same input-id
  streams and the same LRU miss rates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cache import CooperativeCacheArray as JCoopArray
from repro.core.cache import LRUCache as JLRU
from repro.core.feature_loader import FeatureStore as JFeatureStore
from repro.core.minibatch import CapacityPlan as JCapacityPlan
from repro.core.minibatch import build_minibatch as j_build
from repro.core.rng import DependentRNG as JDependentRNG
from repro.core.samplers import make_sampler as j_make_sampler
from repro.store import ClockCache as JClockCache
from repro.store import TieredFeatureStore as JTiered
from repro_torch.core import (
    CapacityPlan,
    CooperativeCacheArray,
    DependentRNG,
    FeatureStore,
    Graph,
    LRUCache,
    build_minibatch,
    make_sampler,
)
from repro_torch.store import ClockCache, TieredFeatureStore

torch.set_num_threads(1)  # the suite runs files in parallel workers

INVALID = np.int32(2**31 - 1)
V = 2048
BATCH = 128
STEPS = 16
KAPPA = {"iid": 1, "smoothed": 8, "nested": 4}


def make_trace(schedule, kappa=None, steps=STEPS, batch=BATCH, num_ids=V, seed=0):
    """(batch,) int32 id arrays under an iid / smoothed / nested schedule,
    about 5% of each batch INVALID padding."""
    kappa = kappa or KAPPA[schedule]
    rng = np.random.default_rng(seed)
    out, cur, pool = [], rng.integers(0, num_ids, batch), None
    for s in range(steps):
        if schedule == "iid":
            cur = rng.integers(0, num_ids, batch)
        elif schedule == "smoothed":
            resample = rng.random(batch) < 1.0 / kappa
            cur = np.where(resample, rng.integers(0, num_ids, batch), cur)
        else:  # nested
            if s % kappa == 0:
                pool = rng.choice(num_ids, size=min(kappa * batch, num_ids), replace=False)
            cur = rng.choice(pool, size=batch, replace=False)
        ids = cur.astype(np.int32).copy()
        ids[rng.random(batch) < 0.05] = INVALID
        out.append(ids)
    return out


def test_lru_exact_semantics_as_jax():
    port, ref = LRUCache(capacity=2), JLRU(capacity=2)
    for ids in ([1, 2], [1], [3], [2]):
        assert port.access_batch(np.asarray(ids)) == ref.access_batch(np.asarray(ids))
        np.testing.assert_array_equal(port.lru_keys(), ref.lru_keys())
    assert (port.hits, port.misses) == (ref.hits, ref.misses) == (1, 4)


@pytest.mark.parametrize("schedule", ["iid", "smoothed", "nested"])
@pytest.mark.parametrize("capacity", [V // 2, 3 * BATCH // 2, BATCH // 2],
                         ids=["large", "near-batch", "fallback"])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_lru_misses_and_keys_equal(schedule, capacity, as_tensor):
    trace = make_trace(schedule, seed=1)
    port, ref = LRUCache(capacity), JLRU(capacity)
    for step, ids in enumerate(trace):
        arg = torch.from_numpy(ids) if as_tensor else ids
        assert port.access_batch(arg) == ref.access_batch(ids), step
        np.testing.assert_array_equal(port.lru_keys(), ref.lru_keys(), err_msg=f"step {step}")
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
    assert port.miss_rate == ref.miss_rate
    assert port.misses > 0 and (port.hits > 0 or capacity < BATCH)  # LRU floods below
    keys = port.lru_keys()
    port.reset_stats()
    assert (port.hits, port.misses, port.miss_rate) == (0, 0, 0.0)
    assert len(keys) <= capacity and np.array_equal(port.lru_keys(), keys)


def test_lru_all_invalid_and_empty_batches():
    port, ref = LRUCache(8), JLRU(8)
    for ids in (np.full(5, INVALID), np.zeros(0, np.int32), np.asarray([3, INVALID, 3])):
        assert port.access_batch(ids) == ref.access_batch(ids)
    np.testing.assert_array_equal(port.lru_keys(), ref.lru_keys())
    assert (port.hits, port.misses) == (ref.hits, ref.misses) == (0, 1)


@pytest.mark.parametrize("num_pes,capacity", [(2, 96), (4, 256)])
def test_cooperative_cache_array_equal(num_pes, capacity):
    traces = [make_trace("smoothed", seed=10 + p) for p in range(num_pes)]
    port, ref = CooperativeCacheArray(num_pes, capacity), JCoopArray(num_pes, capacity)
    for step in range(STEPS):
        ids = np.stack([tr[step] for tr in traces])
        assert port.access(torch.from_numpy(ids)) == ref.access(ids), step
    assert port.miss_rate == ref.miss_rate
    for a, b in zip(port.caches, ref.caches):
        np.testing.assert_array_equal(a.lru_keys(), b.lru_keys())
    port.reset_stats()
    ref.reset_stats()
    assert port.miss_rate == ref.miss_rate == 0.0


def test_cooperative_cache_no_duplication():
    arr = CooperativeCacheArray(num_pes=2, capacity_per_pe=8)
    a = np.asarray([[1, 2, 3], [4, 5, 6]])
    arr.access(a)
    arr.access(a)
    assert arr.miss_rate == 0.5


def _assert_clock_state_equal(port, ref, msg):
    for name in ref.state._fields:
        np.testing.assert_array_equal(getattr(port.state, name).numpy(),
                                      np.asarray(getattr(ref.state, name)),
                                      err_msg=f"{name} {msg}")


@pytest.mark.parametrize("schedule", ["iid", "smoothed", "nested"])
@pytest.mark.parametrize("num_pes,capacity,ways", [(1, 256, 8), (4, 192, 4)])
def test_clock_cache_state_equal_every_batch(schedule, num_pes, capacity, ways):
    traces = [make_trace(schedule, seed=3 + p) for p in range(num_pes)]
    port = ClockCache(capacity, ways, num_pes=num_pes, device="cpu")
    ref = JClockCache(capacity, ways, num_pes=num_pes)
    for step in range(STEPS):
        ids = np.stack([tr[step] for tr in traces])
        if num_pes == 1:
            ids = ids[0]
        got = port.access_batch(torch.from_numpy(ids))
        assert got == ref.access_batch(ids), step
        _assert_clock_state_equal(port, ref, f"after batch {step}")
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
    assert port.hit_rate == ref.hit_rate and port.miss_rate == ref.miss_rate
    assert port.hits > 0 and port.misses > 0
    assert port.access is not None and port.access.__func__ is ClockCache.access_batch


def test_clock_cache_shape_error_and_reset_stats():
    port = ClockCache(64, 8, num_pes=4, device="cpu")
    ref = JClockCache(64, 8, num_pes=4)
    bad = np.zeros((3, 5), np.int32)
    with pytest.raises(ValueError, match="P=4"):
        port.access_batch(bad)
    with pytest.raises(ValueError):
        ref.access_batch(bad)
    with pytest.raises(ValueError, match="P=4"):
        port.access(np.zeros(20, np.int32))
    traces = [make_trace("nested", seed=30 + p, num_ids=256, batch=32) for p in range(4)]
    for step in range(6):
        ids = np.stack([tr[step] for tr in traces])
        assert port.access(ids) == ref.access(ids)
    tags = port.state.tags.clone()
    port.reset_stats()
    ref.reset_stats()
    assert (port.hits, port.misses, port.miss_rate, port.hit_rate) == (0, 0, 0.0, 0.0)
    assert int(port.state.requested.sum()) == 0
    assert torch.equal(port.state.tags, tags)  # contents stay
    for step in range(6, STEPS):
        ids = np.stack([tr[step] for tr in traces])
        assert port.access(ids) == ref.access(ids)
    _assert_clock_state_equal(port, ref, "after reset and 10 more batches")


@pytest.mark.parametrize("num_pes", [1, 2])
def test_tiered_miss_rate_and_reset_stats(num_pes):
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((V, 8)).astype(np.float32)
    port = TieredFeatureStore(feats, capacity=256, ways=8, num_pes=num_pes, device="cpu")
    ref = JTiered(feats, capacity=256, ways=8, num_pes=num_pes)
    traces = [make_trace("smoothed", seed=40 + p) for p in range(num_pes)]

    def run(steps):
        for step in steps:
            ids = np.stack([tr[step] for tr in traces])
            ids = ids[0] if num_pes == 1 else ids
            np.testing.assert_array_equal(port.gather(torch.from_numpy(ids)).numpy(),
                                          np.asarray(ref.gather(ids)))
        assert (port.hits, port.misses, port.requested, port.fetched_rows, port.batches) == (
            ref.hits, ref.misses, ref.requested, ref.fetched_rows, ref.batches)
        assert port.miss_rate == ref.miss_rate and port.hit_rate == ref.hit_rate

    run(range(8))
    assert 0 < port.miss_rate < 1
    data = port.data.clone()
    port.reset_stats()
    ref.reset_stats()
    assert (port.hits, port.misses, port.requested, port.fetched_rows, port.batches) == (
        0, 0, 0, 0, 0)
    assert port.miss_rate == 0.0 and torch.equal(port.data, data)
    run(range(8, STEPS))  # the warm cache serves on, counted from zero


def test_count_duplicates_across_pes_equal():
    rng = np.random.default_rng(6)
    feats = np.zeros((V, 4), np.float32)
    port, ref = FeatureStore(torch.from_numpy(feats)), JFeatureStore(jnp.asarray(feats))
    for P, n, hi in ((4, 64, 200), (2, 300, V), (3, 10, 5)):
        ids = rng.integers(0, hi, (P, n)).astype(np.int32)
        ids[rng.random((P, n)) < 0.2] = INVALID
        want = ref.count_duplicates_across_pes(ids)
        assert port.count_duplicates_across_pes(ids) == want
        assert port.count_duplicates_across_pes(torch.from_numpy(ids)) == want
    assert port.count_duplicates_across_pes(np.asarray([[1, 2], [2, 3]])) == 1


def _port_graph(g) -> Graph:
    return Graph(
        indptr=torch.from_numpy(np.array(g.indptr)),
        indices=torch.from_numpy(np.array(g.indices)),
        edge_types=None, max_degree=g.max_degree, num_vertices=g.num_vertices,
        num_edges=g.num_edges, num_edge_types=g.num_edge_types,
    )


def test_kappa_sweep_lru_miss_rates_equal(small_graph):
    """``tests/test_dependent_cache.py``'s sweep: LABOR-0 fanout 5, 2 layers,
    batch 64, 12 steps, κ 1 and 16; the input ids of every step and the LRU
    miss rates (capacity V/4) equal the JAX package's, and fall with κ."""
    g = _port_graph(small_graph)
    V_, batch, steps = small_graph.num_vertices, 64, 12
    jsampler, sampler = j_make_sampler("labor0", fanout=5), make_sampler("labor0", fanout=5)
    jcaps = JCapacityPlan.geometric(batch, 2, 5, V_)
    caps = CapacityPlan.geometric(batch, 2, 5, V_)
    rates = {}
    for kappa in (1, 16):
        rng_np = np.random.default_rng(0)
        port, ref = LRUCache(V_ // 4), JLRU(V_ // 4)
        for step in range(steps):
            seeds = rng_np.choice(V_, size=batch, replace=False).astype(np.int32)
            jmb = j_build(small_graph, jsampler, jnp.asarray(seeds),
                          JDependentRNG(base_seed=11, kappa=kappa, step=step), 2, jcaps)
            mb = build_minibatch(g, sampler, torch.from_numpy(seeds),
                                 DependentRNG(11, kappa, step), 2, caps)
            want = np.asarray(jmb.input_ids)
            np.testing.assert_array_equal(mb.input_ids.numpy(), want,
                                          err_msg=f"kappa {kappa} step {step}")
            assert port.access_batch(mb.input_ids) == ref.access_batch(want)
        assert port.miss_rate == ref.miss_rate
        rates[kappa] = port.miss_rate
    assert rates[16] < rates[1], rates
