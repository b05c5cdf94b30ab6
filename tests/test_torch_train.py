"""The port's training step vs the JAX package's, from the same weights.

* The GCN layer, with its neighbor sum through ``spmm``, against
  ``layer_apply`` within ``atol=1e-5`` (the JAX layer sums the ``w`` slots
  with ``jnp.sum``, the port in slot order).
* Masked cross-entropy parts and Adam against ``repro.train``.
* Loss and every gradient at step 0 of the jitted JAX loss
  (``jax.value_and_grad`` of ``make_loss_fn`` under ``jax.jit``) within
  ``rtol=1e-5`` (``atol=1e-7`` for gradient entries near zero), in both
  modes.
* ``train_gnn``: losses over 4 steps within ``rtol=1e-5`` of
  ``repro.train.loop.train_gnn`` in both modes, and the final weights
  within ``atol=1e-5``.  ``evaluate`` gives the same micro-F1.

Small size: ``rmat_graph(scale=10, edge_factor=8, max_degree=16)``,
16 features, 4 classes, a 2-layer GCN with hidden 32, P = 4, b = 8,
fanout 5, smoothed κ = 4 (c > 0 from step 1), ``plan_backend="fused"``
(on the CPU the plain versions of the kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticGraphDataset as JDataset
from repro.data.synthetic import rmat_graph as j_rmat_graph
from repro.engine import MinibatchEngine as JEngine
from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import init_gnn as j_init_gnn
from repro.models.gnn.layers import layer_apply
from repro.train import loop as jloop
from repro.train import metrics as jmetrics
from repro.train import optim as joptim
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import MinibatchEngine
from repro_torch.models.gnn import GNNConfig, params_from_jax
from repro_torch.train import (
    TrainConfig,
    adam_init,
    adam_update,
    evaluate,
    make_loss_fn,
    masked_softmax_xent_parts,
    train_gnn,
)

torch.set_num_threads(1)  # the suite runs files in parallel workers

STEPS = 4
GNN = dict(model="gcn", num_layers=2, in_dim=16, hidden_dim=32, num_classes=4)
TC = dict(num_pes=4, local_batch=8, fanout=5, num_steps=STEPS, schedule="smoothed",
          kappa=4, eval_every=0, plan_backend="fused", lr=1e-2)


@pytest.fixture(scope="module")
def datasets():
    jds = JDataset(j_rmat_graph(scale=10, edge_factor=8, max_degree=16),
                   feature_dim=16, num_classes=4, seed=0)
    tds = SyntheticGraphDataset(rmat_graph(scale=10, edge_factor=8, max_degree=16,
                                           device="cpu"),
                                feature_dim=16, num_classes=4, seed=0)
    return jds, tds


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, j_init_gnn(jax.random.PRNGKey(0), JGNNConfig(**GNN)))


def _model(jparams):
    return params_from_jax(jparams, GNNConfig(**GNN), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(datasets):
    """The JAX package's train_gnn (4 steps) in both modes, computed once."""
    jds, _ = datasets
    return {mode: jloop.train_gnn(jds, JGNNConfig(**GNN), jloop.TrainConfig(mode=mode, **TC))
            for mode in ("cooperative", "independent")}


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("l", [0, 1])
def test_gcn_layer_matches_layer_apply(jparams, l):
    rng = np.random.default_rng(l)
    n, w, S = 40, 12, 90
    d_in = GNN["in_dim"] if l == GNN["num_layers"] - 1 else GNN["hidden_dim"]
    Ht = rng.standard_normal((S, d_in)).astype(np.float32)
    self_idx = rng.integers(-1, S, n).astype(np.int32)
    nbr_idx = rng.integers(-1, S, (n, w)).astype(np.int32)
    mask = (rng.random((n, w)) < 0.5) & (nbr_idx >= 0)
    want = layer_apply(jax.tree.map(jnp.asarray, jparams["layers"][l]), JGNNConfig(**GNN), l,
                       jnp.asarray(Ht), jnp.asarray(self_idx), jnp.asarray(nbr_idx),
                       jnp.asarray(mask), None)
    layer = _model(jparams).layers[l]
    got = layer(torch.from_numpy(Ht), torch.from_numpy(self_idx),
                torch.from_numpy(nbr_idx), torch.from_numpy(mask))
    _close(got.detach(), want, rtol=0, atol=1e-5)


def test_xent_parts_match(datasets):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((50, 7))).astype(np.float32)
    labels = rng.integers(0, 7, 50).astype(np.int32)
    valid = rng.random(50) < 0.7
    ws, wn = jmetrics.masked_softmax_xent_parts(jnp.asarray(logits), jnp.asarray(labels),
                                                jnp.asarray(valid))
    s, n = masked_softmax_xent_parts(torch.from_numpy(logits), torch.from_numpy(labels),
                                     torch.from_numpy(valid))
    assert int(n) == int(wn)
    _close(float(s), float(ws), rtol=1e-6)


def test_adam_matches(jparams):
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams)
    jp, jst = jax.tree.map(jnp.asarray, jparams), joptim.adam_init(jparams)
    model = _model(jparams)
    params = list(model.parameters())
    flat = [g for layer in grads["layers"] for g in (layer["w"], layer["b"])]
    st = adam_init(params)
    for _ in range(3):
        jp, jst = joptim.adam_update(jp, grads, jst, lr=1e-2)
        st = adam_update(params, [torch.from_numpy(g) for g in flat], st, lr=1e-2)
    assert st.step == int(jst.step) == 3
    for layer, jl in zip(model.layers, jp["layers"]):
        for name in ("w", "b"):
            _close(getattr(layer, name).detach(), jl[name], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
def test_loss_and_grads_step0(datasets, jparams, mode):
    jds, tds = datasets
    tc = TrainConfig(mode=mode, **TC)
    je = JEngine.from_config(jds.graph, jloop.TrainConfig(mode=mode, **TC).engine_config(2),
                             dataset=jds)
    jloss_fn = jloop.make_loss_fn(je, JGNNConfig(**GNN), je.store, jds.labels)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        jax.tree.map(jnp.asarray, jparams), jnp.int32(0))
    te = MinibatchEngine.from_config(tds.graph, tc.engine_config(2), dataset=tds, device="cpu")
    model = _model(jparams)
    loss = make_loss_fn(te, GNNConfig(**GNN), te.store, tds.labels)(model, 0)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _close(float(loss.detach()), float(jloss), rtol=1e-5)
    want = [g for layer in jgrads["layers"] for g in (layer["w"], layer["b"])]
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g, w, rtol=1e-5, atol=1e-7, msg=f"grad {i}")


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
def test_train_gnn_matches_jax(datasets, jparams, jax_runs, mode):
    _, tds = datasets
    got = train_gnn(tds, GNNConfig(**GNN), TrainConfig(mode=mode, **TC),
                    model=_model(jparams), device="cpu", stage_times=True)
    want = jax_runs[mode]
    assert len(got.losses) == len(want.losses) == STEPS
    _close(got.losses, want.losses, rtol=1e-5)
    assert len(set(np.round(got.losses, 4))) > 1  # the weights moved
    for layer, jl in zip(got.params["layers"], want.params["layers"]):
        for name in ("w", "b"):
            _close(layer[name], jl[name], rtol=0, atol=1e-5, msg=name)
    assert [set(s) for s in got.stage_ms] == [
        {"plan", "gather", "forward_backward", "adam"}] * STEPS


def test_evaluate_matches_jax(datasets, jparams):
    jds, tds = datasets
    tc = TrainConfig(mode="cooperative", **TC)
    want = jloop.evaluate(jds, JGNNConfig(**GNN), jax.tree.map(jnp.asarray, jparams),
                          jloop.TrainConfig(mode="cooperative", **TC))
    got = evaluate(tds, GNNConfig(**GNN), _model(jparams), tc, device="cpu")
    assert got == want
