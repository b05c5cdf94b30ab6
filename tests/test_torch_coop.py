"""Cooperative plans of the port vs the JAX package, bit for bit.

* ``SyntheticGraphDataset``: graph, features, labels and splits.
* The owner arrays of all four partitioners.
* ``seed_batch`` under ``iid``, ``smoothed`` (κ = 4) and ``nested``
  (κ = 3), in both modes.
* Every ``CoopMinibatch`` leaf and ``plan_stats`` from ``plan_at(step)``,
  steps 0–3 (smoothed κ = 4, so c > 0 from step 1), under both plan
  backends; the stacked independent plans likewise.  The JAX side runs
  ``plan_at`` as ``train_gnn`` does, compiled with ``jax.jit``.
* ``redistribute``: output equal; its gradient within ``atol=1e-6`` (the
  backward sums a row requested by several peers in another order).

Small size: ``rmat_graph(scale=10, edge_factor=8, max_degree=16)``,
16 features, 4 classes, P = 4, b = 8, fanout 5, two layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cooperative as jcoop
from repro.core.partition import make_partition as j_make_partition
from repro.data.synthetic import SyntheticGraphDataset as JDataset
from repro.data.synthetic import rmat_graph as j_rmat_graph
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MinibatchEngine as JEngine
from repro_torch.core import cooperative as tcoop
from repro_torch.core.partition import cross_edge_ratio, make_partition, ownership_balance
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import EngineConfig, MinibatchEngine

torch.set_num_threads(1)  # the suite runs files in parallel workers

SCALE, EF, MAXDEG = 10, 8, 16
STEPS = 4
CFG = dict(num_pes=4, local_batch=8, num_layers=2, sampler="labor0", fanout=5)


@pytest.fixture(scope="module")
def datasets():
    jds = JDataset(j_rmat_graph(scale=SCALE, edge_factor=EF, max_degree=MAXDEG),
                   feature_dim=16, num_classes=4, seed=0)
    tds = SyntheticGraphDataset(
        rmat_graph(scale=SCALE, edge_factor=EF, max_degree=MAXDEG, device="cpu"),
        feature_dim=16, num_classes=4, seed=0,
    )
    return jds, tds


def _engines(datasets, **kw):
    jds, tds = datasets
    cfg = dict(CFG, **kw)
    return (JEngine.from_config(jds.graph, JEngineConfig(**cfg), dataset=jds),
            MinibatchEngine.from_config(tds.graph, EngineConfig(**cfg), dataset=tds,
                                        device="cpu"))


def test_dataset_equal(datasets):
    jds, tds = datasets
    for name in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(tds.graph, name).numpy(),
                                      np.asarray(getattr(jds.graph, name)))
    assert tds.graph.max_degree == jds.graph.max_degree
    np.testing.assert_array_equal(tds.features, np.asarray(jds.features))
    np.testing.assert_array_equal(tds.labels, np.asarray(jds.labels))
    for split in ("train_ids", "val_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(tds, split), getattr(jds, split))


@pytest.mark.parametrize("kind", ["hash", "block", "bfs", "degree"])
def test_partition_owner_equal(datasets, kind):
    jds, tds = datasets
    jp = j_make_partition(kind, jds.graph, 4, seed=3)
    tp = make_partition(kind, tds.graph, 4, seed=3)
    np.testing.assert_array_equal(tp.owner.numpy(), np.asarray(jp.owner))
    from repro.core.partition import cross_edge_ratio as j_cer
    from repro.core.partition import ownership_balance as j_bal

    assert cross_edge_ratio(tds.graph, tp) == j_cer(jds.graph, jp)
    assert ownership_balance(tds.graph, tp) == j_bal(jds.graph, jp)
    ids = np.array([0, 5, 2**31 - 1, 1023, 7], np.int32)
    np.testing.assert_array_equal(tp.owner_of(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jp.owner_of(jnp.asarray(ids))))


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
@pytest.mark.parametrize("schedule,kappa", [("iid", 1), ("smoothed", 4), ("nested", 3)])
def test_seed_batch_equal(datasets, mode, schedule, kappa):
    je, te = _engines(datasets, mode=mode, schedule=schedule, kappa=kappa)
    for step in range(7):  # nested: crosses two group boundaries
        want = je.seed_batch(step)
        got = te.seed_batch(step)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        st, sj = te.rng_state(step), je.rng_state(step)
        assert (st.z1, st.z2) == (int(sj.z1), int(sj.z2))
        assert np.float32(st.c) == np.asarray(sj.c)


def _leaves(plan):
    """Every integer leaf of a plan, named (float leaves: none)."""
    out = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in layer.__dataclass_fields__:
            val = getattr(layer, name)
            if val is not None:
                out[f"{name}{l}"] = val
    return out


@pytest.fixture(scope="module")
def plans(datasets):
    """plan_at(step) of both packages, steps 0-3, per (mode, backend)."""
    out = {}
    for mode in ("cooperative", "independent"):
        for backend in ("reference", "fused"):
            je, te = _engines(datasets, mode=mode, schedule="smoothed", kappa=4,
                              plan_backend=backend)
            out[mode, backend] = (je, te, [(je.plan_at(s), te.plan_at(s)) for s in range(STEPS)])
    return out


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_plan_at_leaves_equal(plans, mode, backend):
    _, _, pairs = plans[mode, backend]
    for step, (jp, tp) in enumerate(pairs):
        jl, tl = _leaves(jp), _leaves(tp)
        assert set(jl) == set(tl)
        for name in jl:
            want = np.asarray(jl[name])
            got = tl[name].numpy()
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=f"step {step} {name}")
        assert tp.stats() == jp.stats(), step
    if mode == "cooperative":
        assert any(int(jp.layers[0].mask.sum()) for jp, _ in pairs)  # non-trivial


def test_backends_bit_identical(plans):
    for mode in ("cooperative", "independent"):
        ref, fused = plans[mode, "reference"][2], plans[mode, "fused"][2]
        for (_, a), (_, b) in zip(ref, fused):
            for name, t in _leaves(a).items():
                assert torch.equal(t, _leaves(b)[name]), (mode, name)


def test_capacity_plan_equal():
    for args in [(8, 2, 5, 1024, 4), (64, 3, 10, 1 << 18, 4), (3, 1, 2, 50, 2)]:
        t, j = tcoop.CoopCapacityPlan.geometric(*args), jcoop.CoopCapacityPlan.geometric(*args)
        assert (t.caps, t.tilde_caps, t.bucket_caps) == (j.caps, j.tilde_caps, j.bucket_caps)


@pytest.mark.parametrize("n,P,cap", [(200, 4, 16), (200, 4, 64), (37, 3, 5), (0, 2, 4)])
def test_bucketize_equal_with_overflow(n, P, cap):
    rng = np.random.default_rng(n + P)
    ids = rng.integers(0, 1000, n).astype(np.int32)
    ids[rng.random(n) < 0.2] = 2**31 - 1
    owners = rng.integers(0, P, n).astype(np.int32)
    jb, js = jcoop._bucketize(jnp.asarray(ids), jnp.asarray(owners), P, cap)
    tb, ts = tcoop._bucketize(torch.from_numpy(ids), torch.from_numpy(owners), P, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_redistribute_equal_and_grad(plans):
    je, te, pairs = plans["cooperative", "fused"]
    jp, tp = pairs[1]
    rng = np.random.default_rng(5)
    for l in range(len(tp.layers)):
        P, cap = tp.input_ids.shape if l == len(tp.layers) - 1 else tp.layers[l + 1].seeds.shape
        H = rng.standard_normal((P, cap, 6)).astype(np.float32)
        cap_t = te.caps.tilde_caps[l]
        G = rng.standard_normal((P, cap_t, 6)).astype(np.float32)
        jf = lambda h: jcoop.redistribute(je.ex, jp.layers[l], h, cap_t)
        want = np.asarray(jf(jnp.asarray(H)))
        want_g = np.asarray(jax.grad(lambda h: jnp.sum(jf(h) * G))(jnp.asarray(H)))
        Ht = torch.from_numpy(H).requires_grad_(True)
        out = tcoop.redistribute(te.ex, tp.layers[l], Ht, cap_t)
        np.testing.assert_array_equal(out.detach().numpy(), want)
        (g,) = torch.autograd.grad((out * torch.from_numpy(G)).sum(), Ht)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-6)
