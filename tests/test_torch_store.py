"""Tiered feature store of the port vs the JAX package, bit for bit.

The CLOCK state (``tags``, ``ref``, ``hand``) and the hit, miss and
requested counters must be equal after every batch of a κ-scheduled id
trace, and so must each access's outcome (``uniq``, ``hit``, ``slot``,
``fill_slot``).  ``TieredFeatureStore.gather`` rows must equal
``FeatureStore.gather`` bit for bit, with the same fetch accounting as
the JAX tiered store.  The fixed-shape forms are held at the edges: a
one-way cache whose same-batch inserts evict each other, a set asked for
more misses than it has ways, and ``_assemble`` on the dense ``fetched``
block against the jitted JAX ``_assemble``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.feature_loader import FeatureStore as JFeatureStore
from repro.store import TieredFeatureStore as JTiered
from repro.store import clock_access as j_clock_access
from repro.store import clock_init as j_clock_init
from repro.store import hash_set as j_hash_set
from repro.store import unique_rows as j_unique_rows
from repro.store.tiers import _assemble as j_assemble
from repro_torch.core import FeatureStore
from repro_torch.store import (
    TieredFeatureStore,
    clock_access,
    clock_init,
    hash_set,
    unique_rows,
)
from repro_torch.store.tiers import _assemble

torch.set_num_threads(1)  # the suite runs files in parallel workers

INVALID = np.int32(2**31 - 1)
V = 2048
BATCH = 128
STEPS = 16


def make_trace(schedule, kappa, steps=STEPS, batch=BATCH, num_ids=V, seed=0):
    """(batch,) id arrays under an iid / smoothed / nested schedule, with padding."""
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


def test_hash_set_bit_equal():
    ids = np.concatenate([np.arange(-5, 200_000, 3), [INVALID]]).astype(np.int32)
    for S in (1, 64, 1000, 34816):
        np.testing.assert_array_equal(
            hash_set(torch.from_numpy(ids), S).numpy(),
            np.asarray(j_hash_set(jnp.asarray(ids), S)),
        )


def test_unique_rows_bit_equal():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, (3, 40)).astype(np.int32)
    ids[rng.random((3, 40)) < 0.2] = INVALID
    np.testing.assert_array_equal(
        unique_rows(torch.from_numpy(ids)).numpy(), np.asarray(j_unique_rows(jnp.asarray(ids)))
    )


@pytest.mark.parametrize("schedule,kappa", [("iid", 1), ("smoothed", 8), ("nested", 4)])
@pytest.mark.parametrize("capacity,ways,num_pes", [(256, 8, 1), (192, 4, 2), (64, 1, 1)])
def test_clock_state_bit_equal_every_batch(schedule, kappa, capacity, ways, num_pes):
    traces = [make_trace(schedule, kappa, seed=p + 3) for p in range(num_pes)]
    js = j_clock_init(capacity, ways, num_pes)
    ts = clock_init(capacity, ways, num_pes, device="cpu")
    j_access = jax.jit(j_clock_access)
    for step in range(STEPS):
        ids = np.stack([tr[step] for tr in traces])
        js, jacc = j_access(js, j_unique_rows(jnp.asarray(ids)))
        ts, tacc = clock_access(ts, unique_rows(torch.from_numpy(ids)))
        for name in js._fields:
            np.testing.assert_array_equal(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                err_msg=f"{name} after batch {step}",
            )
        for name in jacc._fields:
            np.testing.assert_array_equal(
                getattr(tacc, name).numpy(), np.asarray(getattr(jacc, name)),
                err_msg=f"access.{name} at batch {step}",
            )
    assert int(ts.hits.sum()) > 0 and int(ts.misses.sum()) > 0
    np.testing.assert_array_equal((ts.hits + ts.misses).numpy(), ts.requested.numpy())


@pytest.mark.parametrize("num_pes", [1, 2])
def test_tiered_gather_bit_equal_with_accounting(num_pes):
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((V, 16)).astype(np.float32)
    plain = JFeatureStore(jnp.asarray(feats))
    port_plain = FeatureStore(torch.from_numpy(feats))
    jt = JTiered(feats, capacity=256, ways=8, num_pes=num_pes)
    tt = TieredFeatureStore(feats, capacity=256, ways=8, num_pes=num_pes, device="cpu")
    traces = [make_trace("smoothed", 8, seed=20 + p) for p in range(num_pes)]
    for step in range(STEPS):
        ids = np.stack([tr[step] for tr in traces])
        if num_pes == 1:
            ids = ids[0]
        got = tt.gather(torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(got, np.asarray(plain.gather(jnp.asarray(ids))))
        np.testing.assert_array_equal(got, np.asarray(jt.gather(ids)))
        np.testing.assert_array_equal(got, port_plain.gather(torch.from_numpy(ids)).numpy())
        assert (tt.fetched_rows, tt.hits, tt.misses, tt.requested) == (
            jt.fetched_rows, jt.hits, jt.misses, jt.requested
        ), step
    assert tt.requested == sum(
        port_plain.count_fetched(np.stack([tr[s] for tr in traces])) for s in range(STEPS)
    )
    assert tt.hits > 0 and tt.fetched_rows == tt.misses


def test_feature_store_gather_vs_jax_on_out_of_range_ids():
    """The port's ``FeatureStore.gather`` equals the JAX ``FeatureStore.gather``
    on INVALID (a zero row), in-range ids, and ids outside ``[0, V)``, which
    both clamp into range (``-2`` gives row 0, ``V + 7`` row ``V - 1``)."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((V, 8)).astype(np.float32)
    inside = np.concatenate([rng.integers(0, V, 32), [0, V - 1, INVALID]]).astype(np.int32)
    outside = np.asarray([-2, -(2**31), V, V + 7, INVALID - 1], np.int32)
    port, ref = FeatureStore(torch.from_numpy(feats)), JFeatureStore(jnp.asarray(feats))
    for ids in (inside, outside, np.concatenate([outside, inside]).reshape(2, -1)):
        np.testing.assert_array_equal(port.gather(torch.from_numpy(ids)).numpy(),
                                      np.asarray(ref.gather(jnp.asarray(ids))))
    np.testing.assert_array_equal(port.gather(torch.from_numpy(outside)).numpy(),
                                  feats[np.clip(outside, 0, V - 1)])


def _same_set_ids(num_sets: int, count: int, start: int = 0) -> np.ndarray:
    """``count`` ids from ``start`` up that hash to set 0 of ``num_sets``."""
    ids = np.arange(start, start + 64 * count * num_sets, dtype=np.int32)
    hit = ids[hash_set(torch.from_numpy(ids), num_sets).numpy() == 0]
    assert len(hit) >= count
    return hit[:count]


def _access_both(js, ts, ids):
    js, jacc = jax.jit(j_clock_access)(js, j_unique_rows(jnp.asarray(ids)))
    ts, tacc = clock_access(ts, unique_rows(torch.from_numpy(ids)))
    for name in js._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in jacc._fields:
        np.testing.assert_array_equal(getattr(tacc, name).numpy(),
                                      np.asarray(getattr(jacc, name)), err_msg=name)
    return js, ts, jacc, tacc


def test_clock_access_fixed_shape_edge_cases_bit_equal():
    # W = 1: every round inserts into the one way, so a set's later misses
    # evict its earlier same-batch inserts, which must not keep their slot
    S = 4
    ids = np.concatenate([_same_set_ids(S, 3), np.full(2, INVALID, np.int32)])[None]
    js, ts = j_clock_init(S, 1, 1), clock_init(S, 1, 1, device="cpu")
    js, ts, _, tacc = _access_both(js, ts, ids)
    fill = tacc.fill_slot.numpy()[0]
    assert (fill >= 0).sum() == 1 and int(ts.misses) == 3  # one survives, all missed
    # more misses in one set than it has ways (W = 4, 7 misses): 4 admitted,
    # 3 dropped; then a batch that hits some and misses again
    S, W = 8, 4
    js, ts = j_clock_init(S * W, W, 2), clock_init(S * W, W, 2, device="cpu")
    many = _same_set_ids(S, 7, start=100)
    ids = np.stack([np.concatenate([many, np.full(3, INVALID, np.int32)]),
                    np.arange(10, dtype=np.int32)])
    js, ts, _, tacc = _access_both(js, ts, ids)
    assert (tacc.fill_slot.numpy()[0] >= 0).sum() == W
    ids = np.stack([np.concatenate([many[::-1], _same_set_ids(S, 3, start=5000)]),
                    np.arange(5, 15, dtype=np.int32)])
    js, ts, jacc, tacc = _access_both(js, ts, ids)
    assert bool(tacc.hit.any()) and int(ts.hits.sum()) > 0


def test_assemble_dense_fetched_bit_equal_to_jax():
    """``_assemble`` (the cache rows with their spare row) against the JAX
    ``_assemble`` on the same access and the same dense ``fetched`` block,
    batch after batch: the output and the cache rows."""
    rng = np.random.default_rng(4)
    P, cap, W, d = 2, 64, 4, 8
    feats = rng.standard_normal((V, d)).astype(np.float32)
    js, ts = j_clock_init(cap, W, P), clock_init(cap, W, P, device="cpu")
    jdata = jnp.zeros((P, cap, d), jnp.float32)
    rows = torch.zeros((P * cap + 1, d))
    traces = [make_trace("smoothed", 4, batch=48, seed=40 + p) for p in range(P)]
    for step in range(8):
        ids = np.stack([tr[step] for tr in traces])
        js, jacc = jax.jit(j_clock_access)(js, j_unique_rows(jnp.asarray(ids)))
        ts, tacc = clock_access(ts, unique_rows(torch.from_numpy(ids)))
        uniq = tacc.uniq.numpy()
        missed = (uniq != INVALID) & ~tacc.hit.numpy()
        fetched = np.zeros(uniq.shape + (d,), np.float32)
        fetched[missed] = feats[np.clip(uniq, 0, V - 1)[missed]]
        want, jdata = jax.jit(j_assemble)(jdata, jacc, jnp.asarray(fetched), jnp.asarray(ids))
        got = _assemble(rows, tacc, torch.from_numpy(fetched), torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"out {step}")
        np.testing.assert_array_equal(rows[:-1].reshape(P, cap, d).numpy(), np.asarray(jdata),
                                      err_msg=f"cache rows {step}")
        assert missed.any() and tacc.hit.numpy().any() or step == 0
