"""The port's NS, random-walk and full samplers vs the JAX package, bit for bit.

* ``hash_pair_u32`` and ``fold`` equal; ``DependentRNG.at_step``.
* ``edge_uniform`` (the NS key ``r_ts``) on 64K id pairs: bit-equal to
  the JAX function compiled with ``jax.jit`` with the step traced, as
  ``plan_at`` and the train step run it, at ``c = 0`` and ``c = i/kappa``.
  Run op by op (eagerly), JAX itself rounds differently from its jitted
  self on 3-13% of the keys (at most 2.4e-7); the port is held to the
  jitted form, and to eager JAX within that bound.
* Where the second seed's hash rounds to the uniform 1.0, ``n2`` is
  infinite and JAX's ``cos * n1 + sin * n2`` is NaN even at ``c = 0``:
  ``vertex_uniform`` and ``edge_uniform`` give NaN there too.
* Every ``LayerSample`` leaf (``seeds``, ``nbr``, ``mask``, ``etypes``) of
  ``ns``, ``rw`` and ``full`` equal to the jitted JAX sampler at kappa = 1
  and kappa = 4, steps 0-3 (``c > 0`` from step 1), layers 0 and 2, under
  both neighbor-table backends, on the edge-typed ``rel_graph``.
* Ties (C2): NS rows with a repeated neighbor (equal keys, different
  relation ids) and ``bottom_k`` on keys with many ties; an RW seed whose
  visits all count once, so its ``top_k`` is all ties.
* ``make_sampler`` builds every name and alias, with JAX's row widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro.core.graph import Graph as JGraph
from repro.core.samplers import make_sampler as j_make_sampler
from repro.core.samplers.neighbor import _bottom_k as j_bottom_k
from repro_torch.core import Graph
from repro_torch.core import rng as trng
from repro_torch.core.samplers import (
    FullSampler,
    LaborSampler,
    NeighborSampler,
    RandomWalkSampler,
    make_sampler,
)
from repro_torch.core.samplers.neighbor import bottom_k

torch.set_num_threads(1)  # the suite runs files in parallel workers

INVALID = 2**31 - 1
N_PAIRS = 1 << 16
# ids whose hash under seed 1, salt 0 is at least 2**32 - 128: the uniform 1.0
UNIFORM_ONE_IDS = [63181337, 67451068, 80938307]


def _port_graph(g) -> Graph:
    return Graph(
        indptr=torch.from_numpy(np.array(g.indptr)),
        indices=torch.from_numpy(np.array(g.indices)),
        edge_types=None if g.edge_types is None else torch.from_numpy(np.array(g.edge_types)),
        max_degree=g.max_degree, num_vertices=g.num_vertices,
        num_edges=g.num_edges, num_edge_types=g.num_edge_types,
    ).validate()


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    t = rng.integers(-5, INVALID, N_PAIRS).astype(np.int32)
    t[:64] = INVALID  # padding slots hash too
    s = rng.integers(0, 1 << 20, N_PAIRS).astype(np.int32)
    return t, s


@pytest.mark.parametrize("seed,salt", [(0, 0), (7, 3), (2**31 - 1, 2**30 + 5)])
def test_hash_pair_bit_equal(pairs, seed, salt):
    t, s = pairs
    want = np.asarray(jrng.hash_pair_u32(jnp.asarray(t), jnp.asarray(s), seed, salt))
    got = trng.hash_pair_u32(torch.from_numpy(t), torch.from_numpy(s), seed, salt).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("base_seed,kappa,step", [(0, 1, 0), (5, 4, 6), (2**32 - 3, 1, 9),
                                                  (9, None, 3)])
def test_fold_and_at_step(base_seed, kappa, step):
    j = jrng.DependentRNG(base_seed, kappa).at_step(step)
    t = trng.DependentRNG(base_seed, kappa).at_step(step)
    assert t == trng.DependentRNG(base_seed, kappa, step) and j.step == t.step == step
    for salt in (0, 1000, 1002, 2**31 + 7):
        assert t.fold(salt) == int(j.fold(salt)) == t.state.fold(salt)


@pytest.mark.parametrize("salt,kappa,step", [
    (0, 1, 0), (2, 1, 5),                 # iid: c = 0
    (0, 4, 1), (2, 4, 3), (1, 16, 21),    # smoothed: c > 0
])
def test_edge_uniform_bit_equal_to_jitted_jax(pairs, salt, kappa, step):
    t, s = pairs
    sched = jrng.DependentRNG(0, kappa)
    want = np.asarray(jax.jit(lambda a, b, st: sched.state_at(st).edge_uniform(a, b, salt))(
        jnp.asarray(t), jnp.asarray(s), jnp.int32(step)))
    got = trng.DependentRNG(0, kappa, step).edge_uniform(
        torch.from_numpy(t), torch.from_numpy(s), salt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # eager JAX rounds differently from its jitted self on a few keys
    eager = np.asarray(jrng.DependentRNG(0, kappa, step).edge_uniform(
        jnp.asarray(t), jnp.asarray(s), salt))
    assert (eager != want).mean() < 0.15
    np.testing.assert_allclose(got, eager, rtol=0, atol=2.4e-7)


def test_uniform_one_gives_nan_like_jax():
    ids = np.array(UNIFORM_ONE_IDS + [5, 6], np.int32)
    nbr = np.full(len(ids), 3, np.int32)
    sched = jrng.DependentRNG(0, 1)  # z1 = 0, z2 = 1, c = 0
    want_v = np.asarray(jax.jit(lambda i, st: sched.state_at(st).vertex_uniform(i, 0))(
        jnp.asarray(ids), jnp.int32(0)))
    assert np.isnan(want_v[:3]).all() and np.isfinite(want_v[3:]).all()
    state = trng.DependentRNG(0, 1, 0).state
    np.testing.assert_array_equal(state.vertex_uniform(torch.from_numpy(ids)).numpy(), want_v)
    # the same hash of the pair's second seed reaches edge_uniform's n2 only
    # through hash_pair_u32, so its keys stay finite here
    want_e = np.asarray(jax.jit(lambda a, b, st: sched.state_at(st).edge_uniform(a, b, 0))(
        jnp.asarray(ids), jnp.asarray(nbr), jnp.int32(0)))
    got_e = state.edge_uniform(torch.from_numpy(ids), torch.from_numpy(nbr)).numpy()
    np.testing.assert_array_equal(got_e, want_e)


def _samples_equal(got, want, backend=""):
    for name in ("seeds", "nbr", "mask", "etypes"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == {"mask": torch.bool}.get(name, torch.int32), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} {backend}")


@pytest.mark.parametrize("kappa", [1, 4])
@pytest.mark.parametrize("name", ["ns", "rw", "full"])
def test_layer_samples_bit_equal(rel_graph, name, kappa):
    g, tg = rel_graph, _port_graph(rel_graph)
    rng = np.random.default_rng(7)
    seeds = np.sort(rng.choice(g.num_vertices, 64, replace=False)).astype(np.int32)
    seeds[-4:] = INVALID
    js = j_make_sampler(name, fanout=5)
    sched = jrng.DependentRNG(0, kappa)
    sample = jax.jit(lambda se, st, layer: js.sample_layer(g, se, sched.state_at(st), layer),
                     static_argnums=2)
    for step in range(4):
        for layer in (0, 2):
            want = sample(jnp.asarray(seeds), jnp.int32(step), layer)
            for backend in ("reference", "fused"):
                got = make_sampler(name, fanout=5, backend=backend).sample_layer(
                    tg, torch.from_numpy(seeds), trng.DependentRNG(0, kappa, step).state, layer)
                _samples_equal(got, want, f"step {step} layer {layer} {backend}")
    assert int(got.mask.sum()) > 100


def _jit_sample(graph, sampler, layer):
    """The JAX sampler's layer sample, jitted once, the step traced."""
    return jax.jit(lambda se, st: sampler.sample_layer(
        graph, se, jrng.DependentRNG(0, 1).state_at(st), layer))


@pytest.mark.parametrize("k", [1, 2, 4, 11])
def test_ns_ties_take_the_lower_slot(k):
    """Seed 0's in-neighbors repeat (the pair (5, 0) four times with four
    relation ids): equal keys, so which copies ``top_k`` keeps shows in the
    sampled relation ids; rows shorter than k tie on ``inf``."""
    src = np.array([5, 9, 5, 2, 5, 7, 8, 6, 1, 4, 5, 5, 9], np.int64)
    dst = np.array([0] * 11 + [1, 1], np.int64)
    et = np.array([0, 1, 1, 2, 3, 0, 1, 2, 3, 0, 2, 1, 3], np.int32)
    jg = JGraph.from_edges(src, dst, 12, edge_types=et, num_edge_types=4)
    tg = Graph.from_edges(src, dst, 12, edge_types=et, num_edge_types=4, device="cpu")
    seeds = np.array([0, 1, 3, INVALID], np.int32)
    sample = _jit_sample(jg, j_make_sampler("ns", fanout=k), 0)
    for step in range(6):
        want = sample(jnp.asarray(seeds), jnp.int32(step))
        got = make_sampler("ns", fanout=k).sample_layer(
            tg, torch.from_numpy(seeds), trng.DependentRNG(0, 1, step).state, 0)
        _samples_equal(got, want, f"step={step}")


@pytest.mark.parametrize("k", [1, 3, 8])
def test_bottom_k_tie_order(k):
    rng = np.random.default_rng(k)
    keys = rng.choice(np.array([0.1, 0.25, 0.5], np.float32), (50, 8))
    mask = rng.random((50, 8)) < 0.7
    nbr = rng.integers(0, 100, (50, 8)).astype(np.int32)
    want = j_bottom_k(jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(keys), k)
    got = bottom_k(torch.from_numpy(nbr), torch.from_numpy(mask), torch.from_numpy(keys), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


@pytest.mark.parametrize("k,o", [(2, 1), (10, 1), (4, 3)])
def test_rw_ties_take_the_smaller_id(k, o):
    """Seed 0 has 30 in-neighbors with no in-edges of their own: every walk
    visits one neighbor and then dead-ends back to the seed, so 16 walks of
    length 1 visit mostly distinct neighbors once each, and the top k are
    ties broken by the smaller id."""
    src = np.arange(1, 31, dtype=np.int64)
    dst = np.zeros(30, np.int64)
    jg = JGraph.from_edges(src, dst, 32)
    tg = Graph.from_edges(src, dst, 32, device="cpu")
    seeds = np.array([0, 5, INVALID], np.int32)
    sample = _jit_sample(jg, j_make_sampler("rw", fanout=k, walk_length=o), 1)
    for step in range(3):
        want = sample(jnp.asarray(seeds), jnp.int32(step))
        got = make_sampler("rw", fanout=k, walk_length=o).sample_layer(
            tg, torch.from_numpy(seeds), trng.DependentRNG(0, 1, step).state, 1)
        _samples_equal(got, want, f"step={step}")
        assert bool(got.mask[0].all())


def test_make_sampler_builds_every_name(rel_graph):
    tg = _port_graph(rel_graph)
    kinds = {"ns": NeighborSampler, "neighbor": NeighborSampler, "labor0": LaborSampler,
             "labor-0": LaborSampler, "labor*": LaborSampler, "labor-*": LaborSampler,
             "labor_star": LaborSampler, "rw": RandomWalkSampler,
             "randomwalk": RandomWalkSampler, "random_walk": RandomWalkSampler,
             "full": FullSampler, "NS": NeighborSampler}
    for name, kind in kinds.items():
        got = make_sampler(name, fanout=7, backend="fused")
        want = j_make_sampler(name, fanout=7, backend="fused")
        assert isinstance(got, kind) and got.name == want.name, name
        assert got.row_width(tg) == want.row_width(rel_graph), name
        assert got.backend == "fused"
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler("gibbs")
