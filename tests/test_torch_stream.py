"""``MinibatchStream`` of the port: the JAX package's pipeline semantics,
and the JAX package's items, bit for bit.

Prefetch depth does not change the items (prefetch 0 / 1 / 2 under iid,
smoothed and nested schedules); ``start_step`` offsets the schedule; the
deque drains on exhaustion; an early stop yields exactly the prefix;
negative arguments raise.  Then ``engine.stream(..., fetch_features=True)``
through the tiered cache against the JAX package's stream, in both
modes: every integer plan leaf, the seeds and the features bit-equal after
every item, and the cache counters equal.

Small size: ``rmat_graph(scale=10, edge_factor=8, max_degree=32)``, 32
features, local batch 16, 2 layers, NS fanout 4 (as ``tests/test_stream.py``).
"""
import itertools

import numpy as np
import pytest
import torch

from repro.engine import CacheConfig as JCacheConfig
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MinibatchEngine as JEngine
from repro_torch.core import INVALID, EngineConfig, MinibatchEngine, MinibatchStream, StreamItem
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import CacheConfig

torch.set_num_threads(1)  # the suite runs files in parallel workers

SCHEDULES = [("iid", 1), ("smoothed", 4), ("nested", 4)]
CFG = dict(local_batch=16, num_layers=2, fanout=4, sampler="ns")


@pytest.fixture(scope="module")
def port_graph():
    return rmat_graph(scale=10, edge_factor=8, max_degree=32, seed=0, device="cpu")


@pytest.fixture(scope="module")
def port_dataset(port_graph):
    return SyntheticGraphDataset(port_graph, feature_dim=32, num_classes=8, seed=0)


def _engine(graph, dataset=None, **kw):
    return MinibatchEngine.from_config(graph, EngineConfig(**CFG, **kw), dataset=dataset,
                                       device="cpu")


def _item_key(item):
    return (
        item.step,
        np.asarray(item.seeds).tobytes(),
        item.plan.input_ids.numpy().tobytes(),
        item.plan.seed_ids.numpy().tobytes(),
    )


@pytest.mark.parametrize("schedule,kappa", SCHEDULES)
def test_prefetch_depth_does_not_change_items(port_graph, schedule, kappa):
    runs = []
    for prefetch in (0, 1, 2):
        eng = _engine(port_graph, num_pes=2, schedule=schedule, kappa=kappa, seed=7)
        items = list(eng.stream(5, prefetch=prefetch))
        assert all(isinstance(x, StreamItem) for x in items)
        runs.append([_item_key(x) for x in items])
    assert runs[0] == runs[1] == runs[2]
    assert [k[0] for k in runs[0]] == list(range(5))


def test_start_step_offsets_the_schedule(port_graph):
    eng = _engine(port_graph, schedule="smoothed", kappa=4, seed=7)
    full = [_item_key(x) for x in eng.stream(6, prefetch=2)]
    tail = [_item_key(x) for x in eng.stream(3, start_step=3, prefetch=2)]
    assert full[3:] == tail


def test_exhaustion_and_empty_stream(port_graph):
    eng = _engine(port_graph)
    assert list(eng.stream(0, prefetch=2)) == []
    assert len(eng.stream(0)) == 0
    items = list(eng.stream(2, prefetch=8))  # deeper than the stream: drains
    assert [x.step for x in items] == [0, 1]
    assert len(eng.stream(5, prefetch=3)) == 5
    assert isinstance(eng.stream(1), MinibatchStream)


def test_early_stop_yields_exact_prefix(port_graph):
    eng = _engine(port_graph, schedule="nested", kappa=4, seed=3)
    full = [_item_key(x) for x in eng.stream(6, prefetch=2)]
    prefix = [_item_key(x) for x in itertools.islice(eng.stream(6, prefetch=2), 3)]
    assert prefix == full[:3]


def test_invalid_arguments_rejected(port_graph):
    eng = _engine(port_graph)
    with pytest.raises(ValueError):
        eng.stream(-1)
    with pytest.raises(ValueError):
        eng.stream(3, prefetch=-1)


def test_fetch_features_determinism(port_graph, port_dataset):
    mk = lambda: _engine(port_graph, port_dataset, schedule="smoothed", kappa=4, seed=5,
                         cache=CacheConfig(enabled=True, capacity=256))
    a = list(mk().stream(4, prefetch=2, fetch_features=True))
    b = list(mk().stream(4, prefetch=0, fetch_features=True))
    assert [_item_key(x) for x in a] == [_item_key(x) for x in b]
    for ia, ib in zip(a, b):
        assert ia.features is not None and torch.equal(ia.features, ib.features)
    assert list(mk().stream(1))[0].features is None


@pytest.mark.parametrize("schedule,kappa", SCHEDULES)
def test_seed_rows_valid(port_graph, schedule, kappa):
    eng = _engine(port_graph, num_pes=2, schedule=schedule, kappa=kappa)
    for item in eng.stream(3, prefetch=1):
        seeds = np.asarray(item.seeds)
        valid = seeds[seeds != INVALID]
        assert len(valid) > 0
        assert valid.min() >= 0 and valid.max() < port_graph.num_vertices


def _int_leaves(plan):
    out = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in layer.__dataclass_fields__:
            val = getattr(layer, name)
            if val is not None:
                out[f"{name}{l}"] = val
    return out


@pytest.mark.parametrize("mode,num_pes", [("cooperative", 4), ("independent", 2)])
def test_stream_with_features_equals_jax(small_graph, small_dataset, port_graph, port_dataset,
                                         mode, num_pes):
    """The port's ``stream(fetch_features=True)`` through the tiered cache
    against the JAX package's: items, features and cache counters."""
    kw = dict(CFG, mode=mode, num_pes=num_pes, schedule="smoothed", kappa=4, seed=5)
    jeng = JEngine.from_config(small_graph, JEngineConfig(
        **kw, cache=JCacheConfig(enabled=True, capacity=256)), dataset=small_dataset)
    teng = MinibatchEngine.from_config(port_graph, EngineConfig(
        **kw, cache=CacheConfig(enabled=True, capacity=256)), dataset=port_dataset,
        device="cpu")
    steps = 4
    for ji, ti in zip(jeng.stream(steps, prefetch=2, fetch_features=True),
                      teng.stream(steps, prefetch=2, fetch_features=True)):
        assert ti.step == ji.step
        np.testing.assert_array_equal(ti.seeds, np.asarray(ji.seeds))
        jl, tl = _int_leaves(ji.plan), _int_leaves(ti.plan)
        assert set(jl) == set(tl)
        for name in jl:
            np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]),
                                          err_msg=f"step {ti.step} {name}")
        np.testing.assert_array_equal(ti.features.numpy(), np.asarray(ji.features),
                                      err_msg=f"features at step {ti.step}")
        jt, tt = jeng.tiered, teng.tiered
        assert (tt.hits, tt.misses, tt.requested, tt.fetched_rows, tt.batches) == (
            jt.hits, jt.misses, jt.requested, jt.fetched_rows, jt.batches), ti.step
        np.testing.assert_array_equal(tt.state.hits.numpy(), np.asarray(jt.state.hits))
    assert teng.tiered.batches == steps and teng.tiered.hits > 0
