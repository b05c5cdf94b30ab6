"""The examples of the port (``examples/*_torch.py``: the four GNN examples
and ``serve_lm_torch``) vs the same calls made through the JAX package's
API at the same configuration.

Each example's body is a function whose keyword defaults are its JAX
twin's constants; here it runs smaller (``rmat_graph`` scale 10, a few
steps or requests) on the CPU and is held to the JAX calls: integer
counts equal (feature rows fetched, LRU miss rates, serve accounting and
``compiles``), losses within ``rtol=1e-4``, RNG correlations within
``atol=1e-6``, micro-F1 equal; the served LM's greedy tokens equal.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JEngineConfig
from repro.core import LRUCache as JLRUCache
from repro.core import MinibatchEngine as JEngine
from repro.core.rng import DependentRNG as JDependentRNG
from repro.data import rmat_graph as j_rmat_graph
from repro.data.recsys import make_recsys as j_make_recsys
from repro.data.synthetic import SyntheticGraphDataset as JDataset
from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import init_gnn as j_init_gnn
from repro.serve import GNNServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro.serve import poisson_trace as j_poisson_trace
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import evaluate as j_evaluate
from repro.train.loop import train_gnn as j_train_gnn

torch.set_num_threads(1)  # the suite runs files in parallel workers

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
LOSS_RTOL = 1e-4
SCALE = 10


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_jax():
    got = _example("quickstart_torch").quickstart(scale=SCALE, train_steps=3, device="cpu")
    graph = j_rmat_graph(scale=SCALE, edge_factor=8, max_degree=32, seed=0)
    cfg = JEngineConfig(mode="independent", num_pes=4, local_batch=128, num_layers=3,
                        sampler="labor0", fanout=5, seed=0)
    indep = int(JEngine.from_config(graph, cfg).plan_at(0).num_inputs)
    coop = 4 * JEngine.from_config(graph, cfg.with_mode("cooperative")).plan_at(0).stats()[
        "inputs"]
    assert (got["num_vertices"], got["num_edges"]) == (graph.num_vertices, graph.num_edges)
    assert (got["indep_inputs"], got["coop_inputs"]) == (indep, coop)
    ds = JDataset(graph, feature_dim=32, num_classes=8, seed=0)
    gnn = JGNNConfig(model="gcn", num_layers=2, in_dim=32, hidden_dim=64, num_classes=8)
    tc = JTrainConfig(mode="cooperative", num_pes=2, local_batch=64, num_steps=3,
                      fanout=5, eval_every=0)
    want = j_train_gnn(ds, gnn, tc)
    np.testing.assert_allclose(got["losses"], want.losses, rtol=LOSS_RTOL)


def test_dependent_minibatching_matches_jax():
    kappas, steps, ids = (1, None), 4, 1024
    got = _example("dependent_minibatching_torch").dependent_minibatching(
        scale=SCALE, num_ids=ids, kappas=kappas, num_steps=steps, device="cpu")
    r0 = JDependentRNG(7, 64, 0).vertex_uniform(jnp.arange(ids))
    for step, c in got["corr"].items():
        r = JDependentRNG(7, 64, step).vertex_uniform(jnp.arange(ids))
        assert abs(c - float(jnp.corrcoef(r0, r)[0, 1])) <= 1e-6, step
    graph = j_rmat_graph(scale=SCALE, edge_factor=8, max_degree=32, seed=0)
    for kappa in kappas:
        eng = JEngine.from_config(graph, JEngineConfig(
            mode="independent", num_pes=1, local_batch=128, num_layers=2, sampler="labor0",
            fanout=5, schedule="smoothed", kappa=kappa, seed=11))
        cache = JLRUCache(capacity=graph.num_vertices // 2)
        for item in eng.stream(num_steps=steps):
            cache.access_batch(np.asarray(item.plan.input_ids).ravel())
        assert got["miss_rate"][kappa] == cache.miss_rate, kappa


@pytest.mark.parametrize("plan_backend", ["reference", "fused"])
def test_train_cooperative_gnn_matches_jax(tmp_path, plan_backend):
    steps = 2
    got = _example("train_cooperative_gnn_torch").train_cooperative_gnn(
        steps=steps, scale=SCALE, plan_backend=plan_backend, out=str(tmp_path / "ckpt"),
        device="cpu")
    assert (tmp_path / "ckpt.npz").exists()
    ds = JDataset(j_rmat_graph(scale=SCALE, edge_factor=8, max_degree=32, seed=0),
                  feature_dim=64, num_classes=16, seed=0)
    cfg = JGNNConfig(model="gcn", num_layers=3, in_dim=64, hidden_dim=256, num_classes=16)
    tc = JTrainConfig(mode="cooperative", num_pes=4, local_batch=64, num_steps=steps,
                      fanout=10, schedule="smoothed", kappa=16, sampler="labor0",
                      plan_backend=plan_backend, eval_every=1)
    want = j_train_gnn(ds, cfg, tc)
    np.testing.assert_allclose(got["losses"], want.losses, rtol=LOSS_RTOL)
    assert got["val_f1"] == pytest.approx(want.val_f1, abs=1e-9)
    assert got["test_f1"] == pytest.approx(
        j_evaluate(ds, cfg, want.params, tc, split="test"), abs=1e-9)


def test_serve_gnn_matches_jax():
    requests = 40
    got = _example("serve_gnn_torch").serve_gnn(smoke=True, requests=requests, device="cpu")
    assert got["bit_identical"] and got["max_abs_diff"] == 0.0
    ds = j_make_recsys(num_users=512, num_items=256, edges_per_user=6, feature_dim=32,
                       seed=0)
    gnn = JGNNConfig(model="gcn", num_layers=2, in_dim=ds.feature_dim, hidden_dim=64,
                     num_classes=ds.num_classes)
    params = j_init_gnn(jax.random.PRNGKey(0), gnn)
    trace = j_poisson_trace(requests, rate_rps=4000.0, seed_pool=ds.user_ids, seed=1)
    base = JServeConfig(num_layers=2, fanout=5, max_batch=64, max_wait_ms=10.0,
                        use_cache=False)
    keys = ("requests", "batches", "fetched_rows", "requested_rows", "mean_batch")
    want = JServer(ds.graph, ds.features, gnn, params, base).serve_independent(trace)
    rep = got["reports"]["independent"]
    assert [rep.summary()[k] for k in keys] == [want.summary()[k] for k in keys]
    assert rep.compiles == want.compiles
    for policy in ("max_batch", "max_wait_ms", "hybrid"):
        cfg = JServeConfig(**{**base.__dict__, "policy": policy})
        want = JServer(ds.graph, ds.features, gnn, params, cfg).serve_trace(trace)
        rep = got["reports"][policy]
        assert [rep.summary()[k] for k in keys] == [want.summary()[k] for k in keys], policy
        assert [b.bucket for b in rep.batches] == [b.bucket for b in want.batches]
        assert rep.compiles == want.compiles, policy
        assert all(n == 1 for per in rep.compiles.values() for n in per.values())


def test_serve_lm_matches_jax():
    """The reduced gemma2-2b with the reference's weights carried across:
    the example's prompts and greedy tokens are the JAX calls'."""
    from repro.configs import get_config as j_get_config
    from repro.launch.steps import make_serve_step as j_make_serve_step
    from repro.models.transformer import init_decode_state as j_init_decode_state
    from repro.models.transformer import init_lm as j_init_lm
    from repro.models.transformer import prefill_decode as j_prefill_decode
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import lm_params_from_jax

    jcfg = j_get_config("gemma2-2b").reduced()
    params = j_init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_jax(jax.tree.map(np.asarray, params),
                               get_config("gemma2-2b").reduced(), device="cpu")
    got = _example("serve_lm_torch").serve_lm(device="cpu", model=model)
    B, S0, new = 4, 16, 24
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S0)),
                          jnp.int32)
    np.testing.assert_array_equal(got["prompts"], np.asarray(prompts))
    serve = jax.jit(j_make_serve_step(jcfg))
    logits, state = jax.jit(lambda p, st, t: j_prefill_decode(p, jcfg, st, t))(
        params, j_init_decode_state(jcfg, B, S0 + new), prompts)
    out = []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(new):
        out.append(np.asarray(tok)[:, 0])
        logits, state = serve(params, state, tok)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(got["tokens"], np.stack(out, 1))
