"""The port's training step vs the JAX package's, from the same weights.

Every test runs the GCN and, where its body is the same, the GAT (the
GAT cases carry a ``gat-`` id prefix).

* The GCN layer, with its neighbor sum through ``spmm``, and the GAT
  layer, with its attention softmax through ``seg_softmax``, against
  ``layer_apply`` within ``atol=1e-5`` (the JAX layers sum the ``w`` slots
  with ``jnp.sum``, the port in slot or warp order; the GAT port projects
  before it gathers).
* ``params_from_jax`` and ``TrainResult.params`` keep the JAX layout.
* Masked cross-entropy parts and Adam against ``repro.train``.
* Loss and every gradient at step 0 of the jitted JAX loss
  (``jax.value_and_grad`` of ``make_loss_fn`` under ``jax.jit``) within
  ``rtol=1e-5`` (``atol=1e-7`` for gradient entries near zero), in both
  modes.
* ``train_gnn``: losses over 4 steps within ``rtol=1e-5`` of
  ``repro.train.loop.train_gnn`` in both modes, and the final weights
  within ``atol=1e-5``; with no ``model`` given, ``train_gnn`` starts from
  ``init_gnn(cfg, tc.seed)``, the JAX package's weights, so its losses
  are the JAX run's too.  ``evaluate`` gives the same micro-F1.

Small size: ``rmat_graph(scale=10, edge_factor=8, max_degree=16)``,
16 features, 4 classes, a 2-layer GCN with hidden 32 (and a 2-layer
GAT with hidden 32 and 2 heads), P = 4, b = 8,
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
    TrainResult,
    adam_init,
    adam_update,
    evaluate,
    make_loss_fn,
    masked_softmax_xent_parts,
    train_gnn,
)

torch.set_num_threads(1)  # the suite runs files in parallel workers

STEPS = 4
GNNS = {
    "gcn": dict(model="gcn", num_layers=2, in_dim=16, hidden_dim=32, num_classes=4),
    "gat": dict(model="gat", num_layers=2, in_dim=16, hidden_dim=32, num_classes=4,
                num_heads=2),
}
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


def by_model(*cases):
    """Each case for both models; the GCN cases keep their plain ids."""
    if not cases:
        return list(GNNS)
    return [pytest.param(model, case, id=str(case) if model == "gcn" else f"{model}-{case}")
            for model in GNNS for case in cases]


_JPARAMS = {}


def _jparams(model):
    if model not in _JPARAMS:
        _JPARAMS[model] = jax.tree.map(
            np.asarray, j_init_gnn(jax.random.PRNGKey(0), JGNNConfig(**GNNS[model])))
    return _JPARAMS[model]


def _model(model):
    return params_from_jax(_jparams(model), GNNConfig(**GNNS[model]), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(datasets):
    """The JAX package's train_gnn (4 steps), per (model, mode), computed once."""
    jds, _ = datasets
    runs = {}

    def run(model, mode):
        if (model, mode) not in runs:
            runs[model, mode] = jloop.train_gnn(
                jds, JGNNConfig(**GNNS[model]), jloop.TrainConfig(mode=mode, **TC))
        return runs[model, mode]

    return run


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("model,l", by_model(0, 1))
def test_gcn_layer_matches_layer_apply(model, l):
    cfg = GNNS[model]
    rng = np.random.default_rng(l)
    n, w, S = 40, 12, 90
    d_in = cfg["in_dim"] if l == cfg["num_layers"] - 1 else cfg["hidden_dim"]
    Ht = rng.standard_normal((S, d_in)).astype(np.float32)
    self_idx = rng.integers(-1, S, n).astype(np.int32)
    nbr_idx = rng.integers(-1, S, (n, w)).astype(np.int32)
    mask = (rng.random((n, w)) < 0.5) & (nbr_idx >= 0)
    mask[:2] = False  # rows with no valid slot
    want = layer_apply(jax.tree.map(jnp.asarray, _jparams(model)["layers"][l]),
                       JGNNConfig(**cfg), l, jnp.asarray(Ht), jnp.asarray(self_idx),
                       jnp.asarray(nbr_idx), jnp.asarray(mask), None)
    layer = _model(model).layers[l]
    got = layer(torch.from_numpy(Ht), torch.from_numpy(self_idx),
                torch.from_numpy(nbr_idx), torch.from_numpy(mask))
    _close(got.detach(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", by_model())
def test_params_from_jax_keeps_the_jax_layout(model):
    jp = _jparams(model)
    got = TrainResult(model=_model(model)).params
    assert len(got["layers"]) == len(jp["layers"])
    for layer, jl in zip(got["layers"], jp["layers"]):
        assert set(layer) == set(jl)
        for name in jl:
            np.testing.assert_array_equal(layer[name], jl[name])
    bad = {"layers": [dict(jl) for jl in jp["layers"]]}
    bad["layers"][0]["w"] = bad["layers"][0]["w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, GNNConfig(**GNNS[model]), device="cpu")
    bad["layers"][0] = {"b": jp["layers"][0]["b"]}
    with pytest.raises(ValueError, match="parameters"):
        params_from_jax(bad, GNNConfig(**GNNS[model]), device="cpu")


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


def _flat(model, tree):
    """The leaves of a JAX-layout pytree in ``model.parameters()`` order."""
    return [tree["layers"][l][name] for l, layer in enumerate(model.layers)
            for name, _ in layer.named_parameters()]


@pytest.mark.parametrize("model", by_model())
def test_adam_matches(model):
    jparams = _jparams(model)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams)
    jp, jst = jax.tree.map(jnp.asarray, jparams), joptim.adam_init(jparams)
    tmodel = _model(model)
    params = list(tmodel.parameters())
    flat = _flat(tmodel, grads)
    st = adam_init(params)
    for _ in range(3):
        jp, jst = joptim.adam_update(jp, grads, jst, lr=1e-2)
        st = adam_update(params, [torch.from_numpy(g) for g in flat], st, lr=1e-2)
    assert st.step == int(jst.step) == 3
    for got, want in zip(params, _flat(tmodel, jp)):
        _close(got.detach(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model,mode", by_model("cooperative", "independent"))
def test_loss_and_grads_step0(datasets, model, mode):
    jds, tds = datasets
    tc = TrainConfig(mode=mode, **TC)
    je = JEngine.from_config(jds.graph, jloop.TrainConfig(mode=mode, **TC).engine_config(2),
                             dataset=jds)
    jloss_fn = jloop.make_loss_fn(je, JGNNConfig(**GNNS[model]), je.store, jds.labels)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        jax.tree.map(jnp.asarray, _jparams(model)), jnp.int32(0))
    te = MinibatchEngine.from_config(tds.graph, tc.engine_config(2), dataset=tds, device="cpu")
    tmodel = _model(model)
    loss = make_loss_fn(te, GNNConfig(**GNNS[model]), te.store, tds.labels)(tmodel, 0)
    grads = torch.autograd.grad(loss, list(tmodel.parameters()))
    _close(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _flat(tmodel, jgrads)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g, w, rtol=1e-5, atol=1e-7, msg=f"grad {i}")


@pytest.mark.parametrize("model,mode", by_model("cooperative", "independent"))
def test_train_gnn_matches_jax(datasets, jax_runs, model, mode):
    _, tds = datasets
    got = train_gnn(tds, GNNConfig(**GNNS[model]), TrainConfig(mode=mode, **TC),
                    model=_model(model), device="cpu", stage_times=True)
    want = jax_runs(model, mode)
    assert len(got.losses) == len(want.losses) == STEPS
    _close(got.losses, want.losses, rtol=1e-5)
    assert len(set(np.round(got.losses, 4))) > 1  # the weights moved
    for layer, jl in zip(got.params["layers"], want.params["layers"]):
        assert set(layer) == set(jl)
        for name in jl:
            _close(layer[name], jl[name], rtol=0, atol=1e-5, msg=name)
    assert [set(s) for s in got.stage_ms] == [
        {"plan", "gather", "forward_backward", "adam"}] * STEPS


@pytest.mark.parametrize("model", by_model())
def test_train_gnn_default_weights_are_jax_s(datasets, jax_runs, model):
    """With no ``model``, ``train_gnn`` draws ``init_gnn(cfg, tc.seed)``: the
    JAX package's weights for that seed, so its losses are the JAX run's."""
    _, tds = datasets
    got = train_gnn(tds, GNNConfig(**GNNS[model]), TrainConfig(mode="cooperative", **TC),
                    device="cpu")
    _close(got.losses, jax_runs(model, "cooperative").losses, rtol=1e-5)


@pytest.mark.parametrize("model", by_model())
def test_evaluate_matches_jax(datasets, model):
    jds, tds = datasets
    tc = TrainConfig(mode="cooperative", **TC)
    want = jloop.evaluate(jds, JGNNConfig(**GNNS[model]),
                          jax.tree.map(jnp.asarray, _jparams(model)),
                          jloop.TrainConfig(mode="cooperative", **TC))
    got = evaluate(tds, GNNConfig(**GNNS[model]), _model(model), tc, device="cpu")
    assert got == want
