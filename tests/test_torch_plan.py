"""Plan construction of the port vs the JAX package, bit for bit.

* ``hash_u32`` / ``uniform_from_u32`` on 1M ids.
* ``vertex_uniform`` (``norm.cdf(norm.ppf(u))``, the LABOR variate) on
  256K ids: bit-equal to the JAX function compiled with ``jax.jit``, which is how
  the JAX server and ``plan_at`` run it.  Run op by op (eagerly), JAX
  itself rounds differently on about 3% of the values (at most 1.2e-7);
  the LABOR-0 accept decisions still agree with it on every threshold
  ``min(1, k/d)``, d = 1..64.
* Every ``Minibatch`` leaf (``seeds``, ``self_idx``, ``nbr_idx``, ``mask``,
  ``input_ids``) equal for labor0 and labor*, L in {1, 2, 3}, fanout in
  {3, 5}, under both plan backends, on ``rmat_graph(scale=10)`` and a
  small ``make_recsys``; the engine facade likewise.
* ``layer_to_coo`` (rows, cols, indptr) equal on every layer of one plan,
  under both backends, with and without dropped edges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro.core.minibatch import CapacityPlan as JCapacityPlan
from repro.core.minibatch import build_minibatch as j_build
from repro.core.minibatch import layer_to_coo as j_layer_to_coo
from repro.core.samplers import make_sampler as j_make_sampler
from repro.data.recsys import make_recsys as j_make_recsys
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MinibatchEngine as JEngine
from repro_torch.core import Graph, build_minibatch, layer_to_coo, make_sampler
from repro_torch.core import rng as trng
from repro_torch.core.minibatch import CapacityPlan, MinibatchLayer
from repro_torch.data import make_recsys
from repro_torch.engine import EngineConfig, MinibatchEngine

torch.set_num_threads(1)  # the suite runs files in parallel workers

N_IDS = 1 << 20


def _port_graph(g) -> Graph:
    return Graph(
        indptr=torch.from_numpy(np.array(g.indptr)),
        indices=torch.from_numpy(np.array(g.indices)),
        edge_types=None, max_degree=g.max_degree, num_vertices=g.num_vertices,
        num_edges=g.num_edges, num_edge_types=g.num_edge_types,
    )


@pytest.fixture(scope="module")
def ids():
    return np.arange(N_IDS, dtype=np.int32) * 7 - 3 * N_IDS  # negatives too


@pytest.mark.parametrize("seed,salt", [(0, 0), (7, 3), (2**31 - 1, 2**30 + 5)])
def test_hash_and_uniform_bit_equal(ids, seed, salt):
    h = trng.hash_u32(torch.from_numpy(ids), seed, salt).numpy()
    jh = np.asarray(jrng.hash_u32(jnp.asarray(ids), seed, salt)).astype(np.int64)
    np.testing.assert_array_equal(h, jh)
    u = trng.uniform_from_u32(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(u, np.asarray(jrng.uniform_from_ids(jnp.asarray(ids), seed, salt)))


@pytest.mark.parametrize("base_seed,salt,kappa,step", [
    (0, 0, 1, 0), (0, 1, 1, 0), (11, 2, 1, 4),  # iid: c = 0
    (0, 0, 8, 3), (5, 1, 16, 21),               # smoothed: c > 0
])
def test_vertex_uniform_bit_equal_to_jitted_jax(ids, base_seed, salt, kappa, step):
    # the step is a traced argument, as in ``plan_at`` and the jitted train step
    ids = ids[: 1 << 18]
    sched = jrng.DependentRNG(base_seed, kappa)
    want = np.asarray(jax.jit(lambda i, s: sched.state_at(s).vertex_uniform(i, salt))(
        jnp.asarray(ids), jnp.int32(step)))
    got = trng.DependentRNG(base_seed, kappa, step).state.vertex_uniform(
        torch.from_numpy(ids), salt
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_smoothed_cos_sin_bit_equal_to_traced_jax():
    # every interpolation coefficient c = i / kappa the smoothed schedule
    # takes for kappa <= 64, with c traced as in ``plan_at``
    f = jax.jit(lambda c: (jnp.cos(c * jnp.pi / 2), jnp.sin(c * jnp.pi / 2)))
    cs = sorted({float(np.float32(i) / np.float32(k)) for k in range(1, 65) for i in range(k)})
    want = f(jnp.asarray(cs, jnp.float32))
    got = np.asarray([trng._cos_sin_half_pi(c) for c in cs], np.float32)
    np.testing.assert_array_equal(got[:, 0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[:, 1], np.asarray(want[1]))


def test_vertex_uniform_accept_masks_match_eager_jax(ids):
    sub = ids[: 1 << 18]
    want = np.asarray(jrng.DependentRNG(0, 1, 0).state.vertex_uniform(jnp.asarray(sub), 0))
    got = trng.DependentRNG(0, 1, 0).state.vertex_uniform(torch.from_numpy(sub), 0).numpy()
    diff = got != want
    assert diff.mean() < 0.06 and np.abs(got - want).max() <= 2.4e-7
    for d in range(1, 65):
        th = np.minimum(np.float32(1), np.float32(5) / np.float32(d))
        np.testing.assert_array_equal(got <= th, want <= th)


def test_ndtri_ndtr_special_values():
    p = torch.tensor([0.0, 1.0, 0.5, 1e-30, 1 - 2**-24], dtype=torch.float32)
    x = trng.ndtri(p)
    assert x[0] == -np.inf and x[1] == np.inf and x[2] == 0.0
    want = np.asarray(jax.jit(jax.scipy.special.ndtri)(p.numpy()))
    np.testing.assert_array_equal(x.numpy(), want)
    z = torch.tensor([-40.0, -9.0, -1.5, -0.3, 0.0, 0.4, 1.2, 3.0, 12.0])
    np.testing.assert_array_equal(
        trng.ndtr(z).numpy(), np.asarray(jax.jit(jax.scipy.special.ndtr)(z.numpy()))
    )


def _leaves(mb):
    out = []
    for layer in mb.layers:
        out += [layer.seeds, layer.self_idx, layer.nbr_idx, layer.mask]
    return out + [mb.input_ids, mb.seed_ids]


def _assert_plans_equal(port_mb, jax_mb):
    a, b = _leaves(port_mb), _leaves(jax_mb)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


_JAX_PLANS = {}


def _jax_plan(key, g, sampler, L, fanout, seeds, caps):
    """JAX reference plan (jitted, as the JAX server builds it), cached per case."""
    if key not in _JAX_PLANS:
        js = j_make_sampler(sampler, fanout=fanout, backend="fused")
        build = jax.jit(lambda s: j_build(g, js, s, jrng.DependentRNG(0, 1, 0),
                                          L, caps, backend="fused"))
        _JAX_PLANS[key] = build(jnp.asarray(seeds))
    return _JAX_PLANS[key]


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("fanout", [3, 5])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("sampler", ["labor0", "labor*"])
def test_minibatch_leaves_bit_equal_rmat(small_graph, sampler, L, fanout, backend):
    g = small_graph
    rng = np.random.default_rng(100 * L + fanout)
    seeds = rng.choice(g.num_vertices, 64, replace=False).astype(np.int32)
    seeds[:3] = seeds[3]  # duplicate seeds dedup in S^0
    caps = JCapacityPlan.geometric(64, L, fanout, g.num_vertices)
    want = _jax_plan(("rmat", sampler, L, fanout), g, sampler, L, fanout, seeds, caps)
    got = build_minibatch(
        _port_graph(g), make_sampler(sampler, fanout=fanout, backend=backend),
        torch.from_numpy(seeds), trng.DependentRNG(0, 1, 0), L,
        CapacityPlan(caps.caps), backend=backend,
    )
    _assert_plans_equal(got, want)
    assert got.stats()["E0"] > 0


@pytest.mark.parametrize("cap", ["slots", "half", "odd"])
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_layer_to_coo_bit_equal(small_graph, backend, cap):
    g = small_graph
    seeds = np.random.default_rng(5).choice(g.num_vertices, 64, replace=False).astype(np.int32)
    caps = JCapacityPlan.geometric(64, 2, 5, g.num_vertices)
    plan = _jax_plan(("rmat", "labor0", 2, 5), g, "labor0", 2, 5, seeds, caps)
    for jl in plan.layers:
        n, w = jl.nbr_idx.shape
        total = int(jl.mask.sum())
        # every slot; half the edges (the rest dropped); past the edges, no block multiple
        cap_edges = {"slots": n * w, "half": total // 2, "odd": total + 7}[cap]
        want = j_layer_to_coo(jl, cap_edges, backend=backend)
        port = MinibatchLayer(*(torch.from_numpy(np.array(x)) for x in (
            jl.seeds, jl.self_idx, jl.nbr_idx, jl.mask)), etypes=None)
        got = layer_to_coo(port, cap_edges, backend=backend)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int((got[0] >= 0).sum()) == min(total, cap_edges)


@pytest.fixture(scope="module")
def recsys_pair():
    kw = dict(num_users=256, num_items=128, edges_per_user=6, feature_dim=16,
              max_degree=32, seed=0)
    return j_make_recsys(**kw), make_recsys(**kw, device="cpu")


def test_recsys_graph_and_features_identical(recsys_pair):
    jd, td = recsys_pair
    np.testing.assert_array_equal(td.graph.indptr.numpy(), np.asarray(jd.graph.indptr))
    np.testing.assert_array_equal(td.graph.indices.numpy(), np.asarray(jd.graph.indices))
    assert td.graph.max_degree == jd.graph.max_degree
    np.testing.assert_array_equal(td.features, np.asarray(jd.features))
    np.testing.assert_array_equal(td.user_ids, jd.user_ids)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("sampler", ["labor0", "labor*"])
def test_minibatch_leaves_bit_equal_recsys(recsys_pair, sampler, backend):
    jd, td = recsys_pair
    rng = np.random.default_rng(5)
    seeds = np.sort(rng.choice(jd.user_ids, 48, replace=False)).astype(np.int32)
    caps = JCapacityPlan.geometric(48, 2, 5, jd.graph.num_vertices)
    want = _jax_plan(("recsys", sampler), jd.graph, sampler, 2, 5, seeds, caps)
    got = build_minibatch(
        td.graph, make_sampler(sampler, fanout=5, backend=backend),
        torch.from_numpy(seeds), trng.DependentRNG(0, 1, 0), 2,
        CapacityPlan(caps.caps), backend=backend,
    )
    _assert_plans_equal(got, want)


def test_engine_build_plan_bit_equal(recsys_pair):
    jd, td = recsys_pair
    kw = dict(local_batch=16, num_layers=2, sampler="labor0", fanout=5,
              seed=3, plan_backend="fused")
    jeng = JEngine.from_config(jd.graph, JEngineConfig(**kw))
    teng = MinibatchEngine.from_config(td.graph, EngineConfig(**kw), device="cpu")
    assert teng.caps.caps == jeng.caps.caps
    seeds = np.concatenate([np.arange(10, 22), np.full(4, 2**31 - 1)]).astype(np.int32)
    want = jax.jit(lambda s: jeng.build_plan(s, rng=jeng.rng_at(0)))(jnp.asarray(seeds))
    got = teng.build_plan(seeds, rng=teng.rng_at(0))
    _assert_plans_equal(got, want)
    assert got.stats() == want.stats()


def test_dependent_rng_schedule_states():
    for kappa, step in [(1, 0), (1, 9), (8, 13), (None, 5)]:
        j = jrng.DependentRNG(3, kappa, step).state
        t = trng.DependentRNG(3, kappa, step).state
        assert (t.z1, t.z2) == (int(j.z1), int(j.z2))
        assert np.float32(t.c) == np.asarray(j.c)


def test_frontier_set_ops_bit_equal():
    from repro.core import frontier as jf
    from repro_torch.core import frontier as tf

    rng = np.random.default_rng(8)
    ids = rng.integers(0, 60, 200).astype(np.int32)
    ids[rng.random(200) < 0.2] = 2**31 - 1
    keep = rng.random(200) < 0.5
    t, j = torch.from_numpy(ids), jnp.asarray(ids)
    for cap in (16, 80, 260):
        np.testing.assert_array_equal(tf.pad_to(t, cap).numpy(), np.asarray(jf.pad_to(j, cap)))
        u = tf.unique_padded(t, cap)
        np.testing.assert_array_equal(u.numpy(), np.asarray(jf.unique_padded(j, cap)))
        np.testing.assert_array_equal(
            tf.lookup(u, t).numpy(), np.asarray(jf.lookup(jnp.asarray(u.numpy()), j))
        )
        np.testing.assert_array_equal(
            tf.compact(t, torch.from_numpy(keep), cap).numpy(),
            np.asarray(jf.compact(j, jnp.asarray(keep), cap)),
        )
    assert int(tf.count_valid(t)) == int(jf.count_valid(j))
    with pytest.raises(ValueError):
        tf.unique_with_inverse(t, 8, backend="pallas")


@pytest.mark.parametrize("sampler", ["labor0", "labor*"])
def test_edge_typed_graph_plan_bit_equal(rel_graph, sampler):
    g = rel_graph
    tg = Graph(
        indptr=torch.from_numpy(np.array(g.indptr)),
        indices=torch.from_numpy(np.array(g.indices)),
        edge_types=torch.from_numpy(np.array(g.edge_types)),
        max_degree=g.max_degree, num_vertices=g.num_vertices,
        num_edges=g.num_edges, num_edge_types=g.num_edge_types,
    ).validate()
    seeds = np.random.default_rng(4).choice(g.num_vertices, 32, replace=False).astype(np.int32)
    caps = JCapacityPlan.geometric(32, 2, 4, g.num_vertices)
    want = _jax_plan(("rel", sampler), g, sampler, 2, 4, seeds, caps)
    got = build_minibatch(tg, make_sampler(sampler, fanout=4, backend="fused"),
                          torch.from_numpy(seeds), trng.DependentRNG(0, 1, 0), 2,
                          CapacityPlan(caps.caps), backend="fused")
    _assert_plans_equal(got, want)
    for a, b in zip(got.layers, want.layers):
        np.testing.assert_array_equal(a.etypes.numpy(), np.asarray(b.etypes))


def test_engine_gather_features_bit_equal(recsys_pair):
    from repro.engine import CacheConfig as JCacheConfig
    from repro_torch.engine import CacheConfig

    jd, td = recsys_pair
    kw = dict(local_batch=16, num_layers=2, sampler="labor0", fanout=5, plan_backend="fused")
    jeng = JEngine.from_config(jd.graph, JEngineConfig(**kw, cache=JCacheConfig(True, 64)), dataset=jd)
    teng = MinibatchEngine.from_config(td.graph, EngineConfig(**kw, cache=CacheConfig(True, 64)),
                                       dataset=td, device="cpu")
    jbuild = jax.jit(lambda s: jeng.build_plan(s, rng=jeng.rng_at(0)))
    for lo in (0, 8, 4):
        seeds = np.arange(lo, lo + 16, dtype=np.int32)
        jplan = jbuild(jnp.asarray(seeds))
        tplan = teng.build_plan(seeds, rng=teng.rng_at(0))
        np.testing.assert_array_equal(
            teng.gather_features(tplan).numpy(), np.asarray(jeng.gather_features(jplan))
        )
    assert (teng.tiered.hits, teng.tiered.fetched_rows) == (jeng.tiered.hits, jeng.tiered.fetched_rows)
