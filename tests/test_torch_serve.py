"""Serving on the port vs the JAX package (both ``plan_backend="fused"``).

The same small user-item graph, ``init_gnn`` weights moved over with
``params_from_jax``, and the same trace through ``repro.serve.GNNServer``
and ``repro_torch.serve.GNNServer(device="cpu")``: every integer count
and per-batch record equal, per-request logits within
``rtol=atol=1e-5`` (float32 sums taken in another order), and
``ServeReport.compiles`` equal to the JAX server's compiles per bucket.
``GNNServer.hot_path`` against the JAX ``hot_path``: ``seed_ids`` bit-equal,
logits within ``atol=1e-5``.  A bucket fed a second shape signature
raises ``RetraceError``.  Inside the port on the CPU, coalesced logits
are bit-identical to per-request ones (mirrors ``tests/test_serve.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.recsys import make_recsys as j_make_recsys
from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import init_gnn as j_init_gnn
from repro.serve import GNNServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro.serve import bursty_trace as j_bursty_trace
from repro.serve import poisson_trace as j_poisson_trace
from repro_torch.data import make_recsys
from repro_torch.models.gnn import GNNConfig, params_from_jax
from repro_torch.serve import (
    POLICIES,
    BucketGuard,
    GNNServer,
    RetraceError,
    ServeConfig,
    bursty_trace,
    poisson_trace,
)

torch.set_num_threads(1)  # the suite runs files in parallel workers

KW = dict(num_users=192, num_items=96, edges_per_user=5, feature_dim=16,
          max_degree=32, seed=0)
GNN_KW = dict(model="gcn", num_layers=2, in_dim=16, hidden_dim=32, num_classes=16)
BATCH_FIELDS = ("index", "bucket", "num_requests", "num_unique", "t_dispatch",
                "service_ms", "fetched_rows", "edges")


@pytest.fixture(scope="module")
def setup():
    jd, td = j_make_recsys(**KW), make_recsys(**KW, device="cpu")
    params = j_init_gnn(jax.random.PRNGKey(0), JGNNConfig(**GNN_KW))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(params_np, GNNConfig(**GNN_KW), device="cpu")
    return jd, td, params, model


def _trace(ds, n=120, rate=800.0, seed=1):
    return poisson_trace(n, rate, ds.user_ids, seed=seed)


def _port_server(td, model, **kw):
    cfg = ServeConfig(plan_backend="fused", **kw)
    return GNNServer(td.graph, td.features, GNNConfig(**GNN_KW), model, cfg, device="cpu")


def test_traces_identical(setup):
    jd, td, _, _ = setup
    for a, b in [(j_poisson_trace(50, 900.0, jd.user_ids, seed=2),
                  poisson_trace(50, 900.0, td.user_ids, seed=2)),
                 (j_bursty_trace(50, 900.0, jd.user_ids, seed=3),
                  bursty_trace(50, 900.0, td.user_ids, seed=3))]:
        assert [dataclasses.astuple(r) for r in a] == [dataclasses.astuple(r) for r in b]


@pytest.mark.parametrize("use_cache", [True, False])
def test_serve_trace_matches_jax_server(setup, use_cache):
    jd, td, params, model = setup
    trace = _trace(jd)
    jcfg = JServeConfig(plan_backend="fused", use_cache=use_cache)
    want = JServer(jd.graph, jd.features, JGNNConfig(**GNN_KW), params, jcfg).serve_trace(trace)
    got = _port_server(td, model, use_cache=use_cache).serve_trace(trace)
    assert (got.fetched_rows, got.requested_rows, got.cache_hits) == (
        want.fetched_rows, want.requested_rows, want.cache_hits
    )
    assert len(got.batches) == len(want.batches) > 2
    for a, b in zip(got.batches, want.batches):
        assert [getattr(a, f) for f in BATCH_FIELDS] == [getattr(b, f) for f in BATCH_FIELDS]
    assert [(s.request.rid, s.batch_index, s.bucket, s.t_complete) for s in got.served] == [
        (s.request.rid, s.batch_index, s.bucket, s.t_complete) for s in want.served
    ]
    for a, b in zip(got.served, want.served):
        np.testing.assert_allclose(a.pred, np.asarray(b.pred), rtol=1e-5, atol=1e-5)
    assert got.summary() == want.summary()
    assert got.compiles == want.compiles
    assert set(got.compiles) == {"serve.plan", "serve.forward"}
    assert all(n == 1 for per in got.compiles.values() for n in per.values())


@pytest.mark.parametrize("use_cache", [False, True])
def test_hot_path_matches_jax(setup, use_cache):
    jd, td, params, model = setup
    jcfg = JServeConfig(plan_backend="fused", max_batch=16, use_cache=False)
    jserver = JServer(jd.graph, jd.features, JGNNConfig(**GNN_KW), params, jcfg)
    server = _port_server(td, model, max_batch=16, use_cache=use_cache)
    for lo, bucket in ((0, 8), (8, 16), (30, 8)):
        seeds = np.asarray(jd.user_ids[lo: lo + bucket], np.int32)
        want_ids, want = jserver.hot_path(jax.numpy.asarray(seeds))
        got_ids, got = server.hot_path(torch.from_numpy(seeds))
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert server._plan_guard.compiles == server._forward_guard.compiles == {8: 1, 16: 1}


def test_bucket_guard_raises_on_a_second_shape(setup):
    _, td, _, model = setup
    server = _port_server(td, model, max_batch=16)
    seeds = torch.as_tensor(td.user_ids[:8], dtype=torch.int32)
    plan = server._plan(seeds)
    H = server._gather(plan)
    server._forward(plan, H)
    server._forward(plan, H.clone())  # same shapes: the same program
    with pytest.raises(RetraceError, match="bucket 8"):
        server._forward(plan, H[:, :-1])  # bucket 8 fed a second shape
    assert server._forward_guard.compiles == {8: 2}
    server._forward(plan, H)  # the first signature again: no new program
    with pytest.raises(RetraceError, match="retraced buckets"):
        server.serve_trace(_trace(td, n=10))
    guard = BucketGuard("step")
    guard.check(8, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(RetraceError):
        guard.check(8, torch.zeros(4, dtype=torch.int64))  # dtype is part of the shape
    guard.check(16, torch.zeros(5))
    assert guard.compiles == {8: 2, 16: 1}


@pytest.fixture(scope="module")
def port_indep(setup):
    _, td, _, model = setup
    return _port_server(td, model).serve_independent(_trace(td))


@pytest.mark.parametrize("policy", POLICIES)
def test_port_coalesced_bit_identical_to_per_request(setup, port_indep, policy):
    _, td, _, model = setup
    rep = _port_server(td, model, policy=policy).serve_trace(_trace(td))
    ref = {s.request.rid: s.pred for s in port_indep.served}
    assert len(rep.served) == len(ref)
    for s in rep.served:
        assert np.array_equal(s.pred, ref[s.request.rid]), (policy, s.request.rid)


def test_port_reset_and_measured_clock(setup):
    _, td, _, model = setup
    # max_batch admits the same batches whatever the measured service times
    server = _port_server(td, model, service_model="measured", policy="max_batch",
                          max_batch=16)
    first = server.serve_trace(_trace(td, n=40))
    assert len(first.batches) == 3
    assert all(b.service_ms == b.wall_ms > 0 for b in first.batches)
    for b in first.batches:  # the stage split adds up to the batch's wall time
        stages = b.plan_ms + b.gather_ms + b.forward_ms
        assert min(b.plan_ms, b.gather_ms, b.forward_ms) > 0
        assert stages == pytest.approx(b.wall_ms, rel=1e-9, abs=1e-9)
    server.reset()
    assert server.tiered.fetched_rows == 0 and server.tiered.hits == 0
    again = server.serve_trace(_trace(td, n=40))
    assert again.fetched_rows == first.fetched_rows
    assert 0.0 <= again.slo_attainment <= 1.0
