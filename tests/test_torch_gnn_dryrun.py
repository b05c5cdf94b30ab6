"""The port's GNN dry-run (``repro_torch.launch.gnn_dryrun``) against the
JAX package's (``repro.launch.gnn_dryrun``).

* The papers100M record (256 PEs, fake CPU tensors, the ``"fused"`` plan
  backend): all-to-all bytes and count equal the reference's, all-reduce
  bytes equal up to the loss scalar (the reference all-reduces the loss
  and its cotangent, 4 bytes each; the port the loss once), dot FLOPs
  equal to the reference's HLO walk's (``GNN_FLOP_TOL``).  The reference's
  record comes from ``tests/dryrun_reference.py`` in a subprocess.
* The pieces, bit for bit on a block-partitioned ``rmat_graph(scale=10)``
  with P = 4: ``LocalGraph.neighbor_table`` (both backends),
  ``neighbor_edge_types``, ``BlockPartition.owner_of``; ``_caps(256)`` for
  both scales; ``_gcn_layer`` and ``_rgcn_layer`` within ``atol=1e-5``.
* ``make_coop_train_step`` at P = 1, one gloo rank, against the
  reference's step in a one-device ``shard_map``: loss within
  ``rtol=5e-6`` and the updated parameters within ``atol=1e-6`` (the
  tolerances of ``tests/test_torch_shard.py``).
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.core import cooperative as j_coop
from repro.data import rmat_graph as j_rmat_graph
from repro.launch import gnn_dryrun as J
from repro.train.optim import adam_init as j_adam_init
from repro_torch.core.cooperative import CoopCapacityPlan
from repro_torch.launch import gnn_dryrun as T

ROOT = Path(__file__).resolve().parents[1]
INVALID = 2**31 - 1
# the port's dot FLOPs against the reference's HLO walk's: every product
# the same shape and count
GNN_FLOP_TOL = (1.0, 1.0)


@pytest.fixture(scope="module")
def gnn_records() -> tuple:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "dryrun_reference.py"),
                          json.dumps([{"gnn": {}}])], capture_output=True, text=True,
                         env=env, timeout=900, check=True)
    ref = json.loads(out.stdout.splitlines()[-1])["record"]
    port = T.trace_gnn_coop_step(verbose=False, device="cpu")
    assert not dist.is_initialized()
    return port, ref


def test_gnn_all_to_all_equal_reference(gnn_records):
    port, ref = gnn_records
    assert port["status"] == ref["status"] == "ok"
    got, want = port["roofline"]["coll_detail"], ref["roofline"]["coll_detail"]
    assert got["all-to-all"] == want["all-to-all"] == {"bytes": 3_994_411_008, "count": 8}


def test_gnn_all_reduce_equal_up_to_the_loss_scalar(gnn_records):
    port, ref = gnn_records
    got, want = port["roofline"]["coll_detail"], ref["roofline"]["coll_detail"]
    assert want["all-reduce"]["bytes"] == 5_431_992
    assert got["all-reduce"]["bytes"] == want["all-reduce"]["bytes"] - 4
    assert got["all-reduce"]["count"] == want["all-reduce"]["count"] == 2


def test_gnn_dot_flops_within_stated_tolerance(gnn_records):
    port, ref = gnn_records
    ratio = port["roofline"]["flops_per_dev"] / ref["hlo"]["dot_flops"]
    assert GNN_FLOP_TOL[0] <= ratio <= GNN_FLOP_TOL[1], ratio
    assert port["overrides"]["backend"] == "fused"
    assert set(port) >= set(ref) - {"lower_s", "compile_s", "hlo"} | {"trace_s"}


@pytest.fixture(scope="module")
def block_graph():
    g = j_rmat_graph(scale=10, edge_factor=8, max_degree=32, num_edge_types=4, seed=3)
    indptr, indices = np.asarray(g.indptr), np.asarray(g.indices)
    etypes = np.asarray(g.edge_types)
    V, P = indptr.shape[0] - 1, 4
    vp = V // P
    p = 1
    lo, hi = indptr[p * vp], indptr[(p + 1) * vp]
    local = dict(indptr=(indptr[p * vp:(p + 1) * vp + 1] - lo).astype(np.int32),
                 indices=indices[lo:hi].astype(np.int32), etypes=etypes[lo:hi].astype(np.int32),
                 v_start=np.int32(p * vp), max_degree=int(g.max_degree))
    rng = np.random.default_rng(0)
    seeds = rng.integers(p * vp, (p + 1) * vp, 40).astype(np.int32)
    seeds[::7] = INVALID
    seeds[3], seeds[5] = 3, V - 1   # out of the block: clipped to a row, as the reference does
    return local, seeds, vp, P


def test_local_graph_and_partition_bit_equal(block_graph):
    local, seeds, vp, P = block_graph
    jg = J.LocalGraph(jnp.asarray(local["indptr"]), jnp.asarray(local["indices"]),
                      jnp.asarray(local["v_start"]), local["max_degree"],
                      edge_types=jnp.asarray(local["etypes"]))
    tg = T.LocalGraph(torch.from_numpy(local["indptr"]), torch.from_numpy(local["indices"]),
                      torch.tensor(local["v_start"]), local["max_degree"],
                      edge_types=torch.from_numpy(local["etypes"]))
    want_nbr, want_mask = (np.asarray(a) for a in jg.neighbor_table(jnp.asarray(seeds)))
    for backend in ("reference", "fused"):
        nbr, mask = tg.neighbor_table(torch.from_numpy(seeds), backend=backend)
        np.testing.assert_array_equal(nbr.numpy(), want_nbr, err_msg=backend)
        np.testing.assert_array_equal(mask.numpy(), want_mask, err_msg=backend)
    np.testing.assert_array_equal(
        tg.neighbor_edge_types(torch.from_numpy(seeds)).numpy(),
        np.asarray(jg.neighbor_edge_types(jnp.asarray(seeds))))
    ids = np.array([0, vp - 1, vp, 3 * vp + 5, 4 * vp + 9, INVALID, 2**30], dtype=np.int32)
    np.testing.assert_array_equal(
        T.BlockPartition(vp, P).owner_of(torch.from_numpy(ids)).numpy(),
        np.asarray(J.BlockPartition(vp, P).owner_of(jnp.asarray(ids))))


@pytest.mark.parametrize("scale", ["papers100M", "mag240M"])
def test_caps_equal(scale):
    j_scale, t_scale = {"papers100M": (J.SCALE, T.SCALE), "mag240M": (J.SCALE_MAG, T.SCALE_MAG)}[scale]
    assert j_scale == t_scale
    for bucket_safety in (3.0, 1.5):
        want = J._caps(256, bucket_safety=bucket_safety, scale=j_scale)
        got = T._caps(256, bucket_safety=bucket_safety, scale=t_scale)
        assert (got.caps, got.tilde_caps, got.bucket_caps) == (
            want.caps, want.tilde_caps, want.bucket_caps)


@pytest.mark.parametrize("model", ["gcn", "rgcn"])
def test_layers_match_reference(model):
    rng = np.random.default_rng(1)
    n, w, t, d_in, d_out, R = 24, 6, 50, 12, 10, 3
    p = {"w": rng.normal(size=(d_in, d_out)).astype(np.float32),
         "b": rng.normal(size=(d_out,)).astype(np.float32),
         "w_rel": rng.normal(size=(R, d_in, d_out)).astype(np.float32)}
    Ht = rng.normal(size=(t, d_in)).astype(np.float32)
    self_idx = rng.integers(-1, t, n).astype(np.int32)
    nbr_idx = rng.integers(-1, t, (n, w)).astype(np.int32)
    mask = rng.random((n, w)) < 0.7
    etypes = rng.integers(0, R, (n, w)).astype(np.int32)
    j_fn, t_fn = (J._rgcn_layer, T._rgcn_layer) if model == "rgcn" else (J._gcn_layer, T._gcn_layer)
    for last in (False, True):
        want = j_fn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(Ht),
                    jnp.asarray(self_idx), jnp.asarray(nbr_idx), jnp.asarray(mask),
                    jnp.asarray(etypes), last)
        got = t_fn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(Ht),
                   torch.from_numpy(self_idx), torch.from_numpy(nbr_idx),
                   torch.from_numpy(mask), torch.from_numpy(etypes), last)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


SMALL = dict(log2_v=10, avg_degree=8, max_degree=32, feat_dim=16, hidden=32, classes=8,
             fanout=10, layers=2, local_batch=64, model="gcn", num_relations=1)


@pytest.fixture
def gloo_rank():
    """One gloo rank (world 1), torn down after the test."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_coop_train_step_p1_matches_reference(gloo_rank, monkeypatch):
    # the reference's LocalGraph takes no backend keyword, which its own
    # LaborSampler passes: accept and ignore it, from outside, as in
    # tests/dryrun_reference.py
    orig = J.LocalGraph.neighbor_table
    monkeypatch.setattr(J.LocalGraph, "neighbor_table",
                        lambda self, seeds, backend=None: orig(self, seeds))
    g = j_rmat_graph(scale=10, edge_factor=8, max_degree=32, seed=5)
    indptr, indices = np.asarray(g.indptr).astype(np.int32), np.asarray(g.indices).astype(np.int32)
    V = indptr.shape[0] - 1
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(V, SMALL["feat_dim"])).astype(np.float32)
    labels = rng.integers(0, SMALL["classes"], V).astype(np.int32)
    seeds = rng.choice(V, SMALL["local_batch"], replace=False).astype(np.int32)
    shapes = [(SMALL["feat_dim"] if l == 1 else SMALL["hidden"],
               SMALL["classes"] if l == 0 else SMALL["hidden"]) for l in range(2)]
    params = [{"w": (0.3 * rng.normal(size=s)).astype(np.float32),
               "b": (0.1 * rng.normal(size=s[1:])).astype(np.float32)} for s in shapes]
    caps = CoopCapacityPlan.geometric(SMALL["local_batch"], 2, 10, V, 1)
    j_caps = j_coop.CoopCapacityPlan(caps.caps, caps.tilde_caps, caps.bucket_caps)

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    j_step = J.make_coop_train_step(1, "pe", j_caps, scale=SMALL)
    j_params = [{k: jnp.asarray(v) for k, v in lp.items()} for lp in params]
    mesh = jax.make_mesh((1,), ("pe",))
    run = jax.jit(shard_map(
        lambda pr, op, a, b, c, f, y, s: j_step(pr, op, a, b, c, f, y, s, jnp.int32(0)),
        mesh=mesh, in_specs=(P(),) * 8, out_specs=(P(), P(), P()), check_rep=False))
    want_params, _, want_loss = run(j_params, j_adam_init(j_params), jnp.asarray(indptr),
                                    jnp.asarray(indices), jnp.int32(0), jnp.asarray(feats),
                                    jnp.asarray(labels), jnp.asarray(seeds))

    t_step = T.make_coop_train_step(1, None, caps, scale=SMALL)
    t_params = [{k: torch.from_numpy(v.copy()).requires_grad_() for k, v in lp.items()}
                for lp in params]
    from repro_torch.train.optim import adam_init

    opt = adam_init([p for lp in t_params for p in lp.values()])
    got_params, opt, loss = t_step(t_params, opt, torch.from_numpy(indptr),
                                   torch.from_numpy(indices), torch.tensor(0, dtype=torch.int32),
                                   torch.from_numpy(feats), torch.from_numpy(labels),
                                   torch.from_numpy(seeds), 0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=5e-6)
    for lg, lw in zip(got_params, want_params):
        for k in lg:
            np.testing.assert_allclose(lg[k].detach().numpy(), np.asarray(lw[k]), atol=1e-6,
                                       err_msg=k)
    assert opt.step == 1
