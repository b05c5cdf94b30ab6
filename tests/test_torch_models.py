"""The port's GraphSAGE and R-GCN vs the JAX package's, from the same weights.

* ``init_gnn`` equals ``repro.models.gnn.init_gnn(PRNGKey(seed), cfg)`` bit
  for bit for ``sage`` and ``rgcn`` (R-GCN's ``(R, d_in, d_out)`` relation
  weights a 3-D Glorot draw), at small widths and at the JAX package's
  mag240M widths (768 in, hidden 1024, 153 classes, 4 relations; two of
  its three layers).
* ``SAGELayer`` and ``RGCNLayer``, their neighbor means through
  ``spmm_mean``, within ``atol=1e-5`` of ``layer_apply`` (C3: the JAX layer
  sums the slots with ``jnp.sum``, the port in slot order); R-GCN with
  relation ids and without (every slot relation 0).
* ``params_from_jax`` and ``TrainResult.params`` keep the JAX layout.
* The edge-typed dataset (graph, relation ids, features, labels, splits)
  equals the JAX package's; the labels' teacher sums neighbor features
  slot by slot, bit-equal to the JAX package's ``np.add.at``.
* ``train_gnn``, 2 steps from its own weights for seed 0: every integer
  leaf of every step's plan (``etypes`` included) equal to the JAX
  engine's ``plan_at``, ``plan_stats`` equal, losses within ``rtol=1e-5``
  of ``repro.train.loop.train_gnn`` and the final weights within
  ``atol=1e-5``: R-GCN with LABOR-0 and GraphSAGE with NS (cooperative),
  R-GCN with NS (independent, stacked plans).

Small size: ``rel_graph`` (``rmat_graph(scale=9, edge_factor=6,
max_degree=24, num_edge_types=4, seed=1)``), 16 features, 4 classes,
2 layers, hidden 32, P = 2, b = 8, fanout 5, smoothed kappa = 4 (c > 0
at step 1), ``plan_backend="fused"`` (on the CPU the plain versions of
the kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticGraphDataset as JDataset
from repro.engine import MinibatchEngine as JEngine
from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import init_gnn as j_init_gnn
from repro.models.gnn.layers import layer_apply
from repro.train import loop as jloop
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.models.gnn import GNN, GNNConfig, RGCNLayer, SAGELayer, init_gnn, params_from_jax
from repro_torch.train import TrainConfig, TrainResult, train_gnn

torch.set_num_threads(1)  # the suite runs files in parallel workers

STEPS = 2
SMALL = dict(num_layers=2, in_dim=16, hidden_dim=32, num_classes=4, num_relations=4)
# two of the mag240M model's three layers: logits (1024 -> 153) and input (768 -> 1024)
MAG = dict(num_layers=2, in_dim=768, hidden_dim=1024, num_classes=153, num_relations=4)
TC = dict(num_pes=2, local_batch=8, fanout=5, num_steps=STEPS, schedule="smoothed",
          kappa=4, eval_every=0, plan_backend="fused", lr=1e-2)


def _cfgs(model, widths=SMALL):
    return JGNNConfig(model=model, **widths), GNNConfig(model=model, **widths)


@pytest.fixture(scope="module")
def datasets(rel_graph):
    tg = rmat_graph(scale=9, edge_factor=6, max_degree=24, num_edge_types=4, seed=1,
                    device="cpu")  # the port's build of ``rel_graph``
    return (JDataset(rel_graph, feature_dim=16, num_classes=4, seed=0),
            SyntheticGraphDataset(tg, feature_dim=16, num_classes=4, seed=0))


def _jparams(model, widths=SMALL, seed=0):
    return jax.tree.map(np.asarray, j_init_gnn(jax.random.PRNGKey(seed), _cfgs(model, widths)[0]))


@pytest.mark.parametrize("model,widths,seed", [
    ("sage", SMALL, 0), ("sage", SMALL, 42), ("rgcn", SMALL, 0), ("rgcn", SMALL, 7),
    ("rgcn", MAG, 0),
])
def test_init_gnn_bit_equal(model, widths, seed):
    want = _jparams(model, widths, seed)
    got = TrainResult(model=init_gnn(_cfgs(model, widths)[1], seed=seed, device="cpu")).params
    assert len(got["layers"]) == len(want["layers"])
    for layer, jl in zip(got["layers"], want["layers"]):
        assert set(layer) == set(jl)
        for name in jl:
            assert layer[name].shape == jl[name].shape, name
            np.testing.assert_array_equal(layer[name], jl[name], err_msg=name)


@pytest.mark.parametrize("model,l,with_etypes", [
    ("sage", 0, False), ("sage", 1, False), ("rgcn", 0, True), ("rgcn", 1, True),
    ("rgcn", 1, False),
])
def test_layer_matches_layer_apply(model, l, with_etypes):
    jcfg, cfg = _cfgs(model)
    rng = np.random.default_rng(l)
    n, w, S = 40, 12, 90
    d_in = cfg.dims(l)[0]
    Ht = rng.standard_normal((S, d_in)).astype(np.float32)
    self_idx = rng.integers(-1, S, n).astype(np.int32)
    nbr_idx = rng.integers(-1, S, (n, w)).astype(np.int32)
    mask = (rng.random((n, w)) < 0.5) & (nbr_idx >= 0)
    mask[:2] = False  # rows with no valid slot
    etypes = rng.integers(0, 4, (n, w)).astype(np.int32) if with_etypes else None
    jp = _jparams(model)["layers"][l]
    want = layer_apply(jax.tree.map(jnp.asarray, jp), jcfg, l, jnp.asarray(Ht),
                       jnp.asarray(self_idx), jnp.asarray(nbr_idx), jnp.asarray(mask),
                       None if etypes is None else jnp.asarray(etypes))
    layer = params_from_jax(_jparams(model), cfg, device="cpu").layers[l]
    assert isinstance(layer, {"sage": SAGELayer, "rgcn": RGCNLayer}[model])
    got = layer(torch.from_numpy(Ht), torch.from_numpy(self_idx), torch.from_numpy(nbr_idx),
                torch.from_numpy(mask), None if etypes is None else torch.from_numpy(etypes))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["sage", "rgcn"])
def test_params_from_jax_keeps_the_jax_layout(model):
    jp = _jparams(model)
    got = TrainResult(model=params_from_jax(jp, _cfgs(model)[1], device="cpu")).params
    for layer, jl in zip(got["layers"], jp["layers"]):
        assert set(layer) == set(jl)
        for name in jl:
            np.testing.assert_array_equal(layer[name], jl[name])
    bad = {"layers": [dict(jl) for jl in jp["layers"]]}
    bad["layers"][0]["w_self"] = bad["layers"][0]["w_self"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, _cfgs(model)[1], device="cpu")
    with pytest.raises(ValueError, match="unknown gnn model"):
        GNN(GNNConfig(model="gin"), device="cpu")


def test_edge_typed_dataset_equal(datasets):
    jds, tds = datasets
    assert (tds.graph.max_degree, tds.graph.num_edge_types) == (
        jds.graph.max_degree, jds.graph.num_edge_types)
    for name in ("indptr", "indices", "edge_types"):
        np.testing.assert_array_equal(getattr(tds.graph, name).numpy(),
                                      np.asarray(getattr(jds.graph, name)))
    for name in ("features", "labels", "train_ids", "val_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(tds, name), np.asarray(getattr(jds, name)))


@pytest.mark.parametrize("d", [1, 33])
def test_neighbor_sum_matches_add_at(datasets, d):
    from repro_torch.data.synthetic import neighbor_sum

    g = datasets[1].graph
    indptr, indices = g.indptr.numpy(), g.indices.numpy()
    feats = np.random.default_rng(d).standard_normal((g.num_vertices, d)).astype(np.float32)
    want = np.zeros_like(feats)
    np.add.at(want, np.repeat(np.arange(g.num_vertices), np.diff(indptr)), feats[indices])
    got = neighbor_sum(feats, indptr, indices, np.diff(indptr))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _leaves(plan):
    """Every integer (and bool) leaf of a plan, named."""
    out = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in layer.__dataclass_fields__:
            val = getattr(layer, name)
            if val is not None:
                out[f"{name}{l}"] = val
    return out


@pytest.mark.parametrize("model,sampler,mode", [
    ("rgcn", "labor0", "cooperative"), ("sage", "ns", "cooperative"),
    ("rgcn", "ns", "independent"),
])
def test_train_gnn_matches_jax(datasets, model, sampler, mode):
    jds, tds = datasets
    jcfg, cfg = _cfgs(model)
    tc = dict(TC, mode=mode, sampler=sampler)
    want = jloop.train_gnn(jds, jcfg, jloop.TrainConfig(**tc))
    plans = []
    got = train_gnn(tds, cfg, TrainConfig(**tc), device="cpu",
                    on_step=lambda step, plan: plans.append(plan))
    je = JEngine.from_config(jds.graph, jloop.TrainConfig(**tc).engine_config(2), dataset=jds)
    for step, tp in enumerate(plans):
        jp = je.plan_at(step)
        jl, tl = _leaves(jp), _leaves(tp)
        assert set(jl) == set(tl) and "etypes0" in tl
        for name in jl:
            want_leaf = np.asarray(jl[name])
            assert tl[name].numpy().dtype == want_leaf.dtype, name
            np.testing.assert_array_equal(tl[name].numpy(), want_leaf,
                                          err_msg=f"step {step} {name}")
        assert tp.stats() == jp.stats()
    assert len(got.losses) == len(want.losses) == STEPS
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    for layer, jl in zip(got.params["layers"], want.params["layers"]):
        assert set(layer) == set(jl)
        for name in jl:
            np.testing.assert_allclose(layer[name], jl[name], rtol=0, atol=1e-5, err_msg=name)
