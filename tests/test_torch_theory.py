"""The port's theory harness and core helpers vs the JAX package.

* ``measure_work_curve`` for ``ns``, ``labor0``, ``labor*`` and ``rw``:
  the expected ``|S^L|`` and work per seed equal the JAX harness's, run
  once with its plan build compiled by ``jax.jit`` (the step's RNG state
  traced), as ``plan_at`` compiles it, and once unchanged, op by op (where
  NS's edge variates may differ from the compiled ones in the last bit).
* ``measure_density_curve``, ``is_monotone_nonincreasing``,
  ``is_concave`` and ``unique_vertex_fraction`` equal.
* ``frontier.union_padded``, ``contains`` and ``multiplicity``, and
  ``minibatch.epoch_stats`` equal.
* ``sgd_update`` (with and without momentum) and ``cosine_lr`` within
  ``rtol=1e-6`` (the JAX package computes them in float32 with XLA's
  ``cos``; the port with numpy's).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jf
from repro.core import theory as jtheory
from repro.core.minibatch import CapacityPlan as JCapacityPlan
from repro.core.minibatch import build_minibatch as j_build
from repro.core.minibatch import epoch_stats as j_epoch_stats
from repro.core.rng import DependentRNG as JDependentRNG
from repro.core.samplers import make_sampler as j_make_sampler
from repro.train import optim as joptim
from repro_torch.core import CapacityPlan, DependentRNG, Graph, build_minibatch, epoch_stats
from repro_torch.core import frontier as tf
from repro_torch.core import theory
from repro_torch.core.samplers import make_sampler
from repro_torch.train import cosine_lr, sgd_update

torch.set_num_threads(1)  # the suite runs files in parallel workers

INVALID = 2**31 - 1
BATCHES = [16, 96]


@pytest.fixture(scope="module")
def graphs(small_graph):
    g = small_graph
    return g, Graph(
        indptr=torch.from_numpy(np.array(g.indptr)),
        indices=torch.from_numpy(np.array(g.indices)),
        edge_types=None, max_degree=g.max_degree, num_vertices=g.num_vertices,
        num_edges=g.num_edges, num_edge_types=g.num_edge_types,
    )


def _jitted_build(monkeypatch, graph):
    """Route the JAX harness's ``build_minibatch`` through one compiled
    program per (sampler, layers, capacities), the RNG state traced."""
    @functools.lru_cache(maxsize=None)
    def compiled(sampler, num_layers, caps):
        return jax.jit(lambda seeds, state: j_build(graph, sampler, seeds, state,
                                                    num_layers, caps))

    def build(g, sampler, seeds, rng, num_layers, caps):
        assert g is graph
        return compiled(sampler, num_layers, caps)(seeds, rng.state)

    monkeypatch.setattr(jtheory, "build_minibatch", build)


@pytest.mark.parametrize("name", ["ns", "labor0", "labor*", "rw"])
def test_work_curve_counts_equal(graphs, monkeypatch, name):
    jg, tg = graphs
    _jitted_build(monkeypatch, jg)
    kw = dict(num_layers=2, trials=2, seed=3, fanout_for_caps=5)
    want = jtheory.measure_work_curve(jg, j_make_sampler(name, fanout=5), BATCHES, **kw)
    got = theory.measure_work_curve(tg, make_sampler(name, fanout=5), BATCHES, **kw)
    assert got.batch_sizes == want.batch_sizes == BATCHES
    assert got.expected_sl == want.expected_sl
    assert got.work_per_seed == want.work_per_seed
    assert theory.is_monotone_nonincreasing(got.work_per_seed, tol=0.05) == \
        jtheory.is_monotone_nonincreasing(want.work_per_seed, tol=0.05)
    assert theory.is_concave(BATCHES, got.expected_sl, tol=0.1) == \
        jtheory.is_concave(BATCHES, want.expected_sl, tol=0.1)


@pytest.mark.parametrize("name", ["ns", "labor0", "labor*", "rw"])
def test_work_curve_counts_equal_unchanged_jax_harness(graphs, name):
    jg, tg = graphs
    kw = dict(num_layers=2, trials=2, seed=3, fanout_for_caps=5)
    want = jtheory.measure_work_curve(jg, j_make_sampler(name, fanout=5), BATCHES, **kw)
    got = theory.measure_work_curve(tg, make_sampler(name, fanout=5), BATCHES, **kw)
    assert got.expected_sl == want.expected_sl
    assert got.work_per_seed == want.work_per_seed


def test_density_curve_equal(graphs):
    jg, tg = graphs
    want = jtheory.measure_density_curve(jg, [32, 128, 512], trials=3, seed=2)
    got = theory.measure_density_curve(tg, [32, 128, 512], trials=3, seed=2)
    assert got == want


@pytest.mark.parametrize("xs", [[3.0, 2.9, 2.95, 1.0], [1.0, 2.0], [5.0, 5.1, 5.2],
                                [4.0, 3.0, 2.0, 1.5]])
def test_curve_checks_equal(xs):
    bs = [8 * 2**i for i in range(len(xs))]
    for tol in (0.0, 0.03, 0.1):
        assert theory.is_monotone_nonincreasing(xs, tol) == \
            jtheory.is_monotone_nonincreasing(xs, tol)
        assert theory.is_concave(bs, xs, tol) == jtheory.is_concave(bs, xs, tol)


def _ids(seed, n=300, hi=80):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, n).astype(np.int32)
    ids[rng.random(n) < 0.2] = INVALID
    return ids


@pytest.mark.parametrize("cap", [8, 64, 400])
def test_union_contains_multiplicity_equal(cap):
    a, b = _ids(1), _ids(2, n=50)
    u = tf.union_padded(torch.from_numpy(a), torch.from_numpy(b.reshape(5, 10)), cap)
    want_u = np.asarray(jf.union_padded(jnp.asarray(a), jnp.asarray(b.reshape(5, 10)), cap))
    np.testing.assert_array_equal(u.numpy(), want_u)
    q = np.concatenate([a[:40], np.array([-1, 81, INVALID], np.int32)])
    np.testing.assert_array_equal(
        tf.contains(u, torch.from_numpy(q)).numpy(),
        np.asarray(jf.contains(jnp.asarray(want_u), jnp.asarray(q))))
    for ids in (np.sort(a), np.sort(np.concatenate([a, a[:7]])), np.full(9, INVALID, np.int32),
                np.array([-1, -1, 2, 2, 2, INVALID], np.int32)):
        counts, starts = tf.multiplicity(torch.from_numpy(ids), cap)
        jc, js = jf.multiplicity(jnp.asarray(ids), cap)
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(starts.numpy(), np.asarray(js))


def test_epoch_stats_equal(graphs):
    jg, tg = graphs
    caps = JCapacityPlan.geometric(32, 2, 5, jg.num_vertices)
    seeds = np.random.default_rng(4).choice(jg.num_vertices, 32, replace=False).astype(np.int32)
    js = j_make_sampler("ns", fanout=5)
    want = jax.jit(lambda s: j_build(jg, js, s, JDependentRNG(0, 1, 0), 2, caps))(
        jnp.asarray(seeds))
    got = build_minibatch(tg, make_sampler("ns", fanout=5), torch.from_numpy(seeds),
                          DependentRNG(0, 1, 0), 2, CapacityPlan(caps.caps))
    assert epoch_stats(got) == j_epoch_stats(want)
    assert epoch_stats(got)["E0"] > 0
    assert theory.unique_vertex_fraction(got.input_ids, per_pe=False) == \
        jtheory.unique_vertex_fraction(want.input_ids, per_pe=False)


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_update_matches(momentum):
    rng = np.random.default_rng(5)
    shapes = [(6, 4), (4,), (2, 3, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jm = [jnp.zeros(s, jnp.float32) for s in shapes] if momentum else None
    tm = [torch.zeros(s) for s in shapes] if momentum else None
    for g in grads:
        jp, jm = joptim.sgd_update(jp, [jnp.asarray(x) for x in g], lr=0.05,
                                   momentum_state=jm, momentum=momentum or 0.9)
        tm = sgd_update(tp, [torch.from_numpy(x) for x in g], lr=0.05,
                        momentum_state=tm, momentum=momentum or 0.9)
    assert (tm is None) == (momentum is None)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_cosine_lr_matches():
    for warmup, total, min_frac in ((10, 100, 0.1), (0, 50, 0.0), (5, 5, 0.2)):
        for step in (0, 1, 4, 5, 9, 10, 11, 37, 50, 99, 100, 150):
            want = float(joptim.cosine_lr(step, 3e-3, warmup, total, min_frac))
            got = cosine_lr(step, 3e-3, warmup, total, min_frac)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{step} {warmup} {total}")
