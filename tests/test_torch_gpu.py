"""The port's CUDA kernels and serving path on a card (marker ``gpu``).

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Each kernel must equal its plain torch version bit for bit on the card,
including overflow, all-INVALID and empty inputs, and a served trace
must give the same integer accounting and plan entries as on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import make_recsys
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.frontier_gather import frontier_gather, frontier_gather_ref
from repro_torch.kernels.unique_compact import unique_with_inverse, unique_with_inverse_ref
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.serve import GNNServer, ServeConfig, poisson_trace
from repro_torch.store import probe_ref, tag_probe

INVALID = 2**31 - 1
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ids(n, hi, invalid_frac, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, size=n).astype(np.int32)
    ids[rng.random(n) < invalid_frac] = INVALID
    return torch.from_numpy(ids)


def test_frontier_gather_matches_plain(cuda):
    ds = make_recsys(num_users=2048, num_items=512, edges_per_user=6,
                     feature_dim=8, max_degree=32, seed=1, device=cuda)
    g = ds.graph
    for n, frac in [(300, 0.1), (64, 1.0), (0, 0.0), (5000, 0.0)]:
        seeds = _ids(n, g.num_vertices, frac, n).to(cuda)
        got = frontier_gather(g.indptr, g.indices, seeds, g.max_degree)
        want = frontier_gather_ref(g.indptr, g.indices, seeds, g.max_degree)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), n
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,cap,hi", [
    (5000, 300, 700),    # overflow: cap < uniques
    (3000, 4000, 700),   # cap > uniques
    (40000, 4096, 2**20),
    (1, 1, 5), (0, 4, 5),
])
def test_unique_compact_matches_plain(cuda, m, cap, hi):
    ids = _ids(m, hi, 0.3, m).to(cuda)
    got = unique_with_inverse(ids, cap)
    want = unique_with_inverse_ref(ids, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    all_invalid = torch.full((777,), INVALID, dtype=torch.int32, device=cuda)
    got = unique_with_inverse(all_invalid, cap)
    assert bool((got[0] == INVALID).all()) and bool((got[1] == -1).all())
    torch.cuda.synchronize()


def test_tag_probe_matches_plain(cuda):
    rng = np.random.default_rng(1)
    for S, W, n in [(256, 8, 4000), (64, 1, 100), (16, 4, 0)]:
        tags = torch.from_numpy(rng.integers(0, 99, (S, W)).astype(np.int32)).to(cuda)
        sets = torch.from_numpy(rng.integers(0, S, n).astype(np.int32)).to(cuda)
        ids = torch.from_numpy(rng.integers(-1, 99, n).astype(np.int32)).to(cuda)
        assert torch.equal(tag_probe(tags, sets, ids), probe_ref(tags, sets, ids))
    torch.cuda.synchronize()


def test_served_trace_matches_cpu(cuda):
    ds = make_recsys(num_users=4096, num_items=512, edges_per_user=8,
                     feature_dim=16, max_degree=64, seed=0, device="cpu")
    cfg = GNNConfig(num_layers=2, in_dim=16, hidden_dim=32, num_classes=8)
    model = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    trace = poisson_trace(200, 2000.0, ds.user_ids, seed=3)
    serve_cfg = ServeConfig(plan_backend="fused")
    reset_launches()
    card = GNNServer(ds.graph, ds.features, cfg, model, serve_cfg, device=cuda)
    got = card.serve_trace(trace)
    assert all(LAUNCHES.get(k, 0) > 0 for k in ("frontier_gather", "unique_compact", "tag_probe"))
    cpu_model = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = GNNServer(ds.graph, ds.features, cfg, cpu_model, serve_cfg,
                     device="cpu").serve_trace(trace)
    assert (got.fetched_rows, got.requested_rows, got.cache_hits) == (
        want.fetched_rows, want.requested_rows, want.cache_hits)
    for a, b in zip(got.batches, want.batches):
        assert (a.bucket, a.num_unique, a.edges, a.fetched_rows) == (
            b.bucket, b.num_unique, b.edges, b.fetched_rows)
    for a, b in zip(got.served, want.served):
        np.testing.assert_allclose(a.pred, b.pred, rtol=1e-5, atol=1e-5)
