"""The port's CUDA kernels and serving path on a card (marker ``gpu``).

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Each kernel must equal its plain torch version bit for bit on the card,
including overflow, all-INVALID and empty inputs (``frontier_gather`` in
both its outputs from one launch, at widths that are not multiples of 4
and rows over the cap; ``tag_probe`` from one launch, also on a tag view
that is not 16-byte aligned and on sets that hold an id twice) and, for
the multi-block ``unique_compact``, the ``spmm`` forward and backward and
``expand_indptr``, their tile, row and run edges (the ``spmm`` forward's
floats also as int32 views, so the sign of a zero counts; the backward
also equals the CPU's plain version and gives the same bits from call to
call), except ``seg_softmax``: its
forward is held within ``atol=1e-6`` of the plain version on the card and
its backward within ``atol=1e-6 * max|g|`` (the kernel calls CUDA's
``expf``, the plain version ``torch.exp``), with masked slots and
all-masked rows exactly 0.  Each kernel rejects a wrongly typed or
non-contiguous input by raising (``seg_softmax`` also floats that are not
16-byte aligned).  A served trace must give the same
integer accounting and plan entries as on the CPU, a few cooperative
training steps (GCN, GAT, GraphSAGE with NS, R-GCN) the same plans and
losses, and the NS, RW, full and LABOR-* samplers the same samples.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import MinibatchLayer, layer_to_coo
from repro_torch.data import SyntheticGraphDataset, make_recsys, rmat_graph
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels._build import call_int
from repro_torch.kernels.expand_indptr import expand_indptr, expand_indptr_cuda, expand_indptr_ref
from repro_torch.kernels.frontier_gather import frontier_gather, frontier_gather_ref
from repro_torch.kernels.gather import gather, gather_cuda, gather_ref
from repro_torch.kernels.seg_softmax import (
    seg_softmax,
    seg_softmax_backward_cuda,
    seg_softmax_backward_ref,
    seg_softmax_cuda,
    seg_softmax_ref,
)
from repro_torch.kernels.spmm import (
    spmm_backward_cuda,
    spmm_backward_ref,
    spmm_cuda,
    spmm_mean,
    spmm_ref,
    spmm_sum,
)
from repro_torch.kernels.unique_compact import (
    unique_compact_cuda,
    unique_compact_sorted_ref,
    unique_with_inverse,
    unique_with_inverse_ref,
)
from repro_torch.engine import MinibatchEngine
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.serve import GNNServer, ServeConfig, poisson_trace
from repro_torch.train import TrainConfig, train_gnn
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


def _frontier_case(case, dev):
    """(indptr, indices, seeds, D) of one ``frontier_gather`` case on ``dev``."""
    rng = np.random.default_rng(len(case))
    if case.startswith("recsys"):  # n and INVALID share on a user-item graph
        _, n, frac = case.split("-")
        g = make_recsys(num_users=2048, num_items=512, edges_per_user=6,
                        feature_dim=8, max_degree=32, seed=1, device=dev).graph
        return g.indptr, g.indices, _ids(int(n), g.num_vertices, float(frac), int(n)).to(dev), \
            g.max_degree
    if case.startswith("D="):  # a graph built with that max_degree
        D = int(case[2:])
        g = rmat_graph(scale=10, edge_factor=8, max_degree=D, seed=D, device=dev)
        assert g.max_degree == D
        return g.indptr, g.indices, _ids(1000, g.num_vertices, 0.1, D).to(dev), D
    V, D = 500, 32
    counts = rng.integers(0, 100 if case == "over-cap" else 40, V)
    if case == "no-edges":
        counts[:] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, V, int(indptr[-1])).astype(np.int32)
    n = {"all-invalid": 777, "n=0": 0}.get(case, 600)
    seeds = _ids(n, V, 1.0 if case == "all-invalid" else 0.1, n).to(dev)
    if case == "odd-offset-view":  # seeds 4 bytes past an allocation's start
        buf = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        buf[1:] = seeds
        seeds = buf[1:]
        assert seeds.data_ptr() % 8 == 4
    if case == "over-cap":
        assert counts.max() > D
    return torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev), seeds, D


@pytest.mark.parametrize("case", [
    "recsys-300-0.1", "recsys-64-1.0", "recsys-0-0.0", "recsys-5000-0.0",
    "D=3", "D=7", "D=32", "D=64", "all-invalid", "n=0", "over-cap", "no-edges",
    "odd-offset-view",
])
def test_frontier_gather_matches_plain(cuda, case):
    """Both outputs (the table and its mask) from one launch, equal to the
    plain version on the card and on the CPU."""
    indptr, indices, seeds, D = _frontier_case(case, cuda)
    reset_launches()
    got = frontier_gather(indptr, indices, seeds, D)
    assert LAUNCHES.get("frontier_gather", 0) == (1 if seeds.numel() else 0)
    want = frontier_gather_ref(indptr, indices, seeds, D)
    assert got[1].dtype == torch.bool and all(torch.equal(a, b) for a, b in zip(got, want))
    cpu = frontier_gather_ref(indptr.cpu(), indices.cpu(), seeds.cpu(), D)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))
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


TILE = 2048  # ids per block of unique_compact.cu, checked against it below


def _dedup_case(case):
    """(ids, cap) of one ``unique_compact`` edge case around the kernel's tiles."""
    scratch = [call_int("unique_compact", "unique_compact_scratch_ints", m)
               for m in (TILE, TILE + 1)]
    assert scratch[0] == 0 < scratch[1], "TILE is not the kernel's tile"
    rng = np.random.default_rng(len(case))
    if case == "tile-1":
        return rng.integers(0, 3000, TILE - 1), 1000
    if case == "tile":
        return rng.integers(0, 3000, TILE), 5000
    if case == "tile+1":
        return rng.integers(0, 3000, TILE + 1), 2999
    if case == "run-over-3-tiles":  # one id repeated across three whole tiles
        return np.concatenate([rng.integers(0, 500, TILE // 2), np.full(3 * TILE, 777),
                               rng.integers(800, 5000, TILE)]), 4000
    if case == "cap-mid-tile":
        return rng.permutation(3 * TILE), TILE + TILE // 2 + 3
    if case == "invalid-tail":  # INVALID over the last 2.5 tiles
        ids = rng.integers(0, 10**6, 4 * TILE)
        ids[np.argsort(ids)[-(5 * TILE // 2):]] = INVALID
        return ids, 2 * TILE
    if case == "cap-past-last-tile":  # INVALID slots of uniq no tile's ranks reach
        return rng.integers(0, 10**6, 2 * TILE + 5), 4 * TILE
    if case == "one-tile-wide-cap":
        return rng.integers(0, 50, 100), 3 * TILE
    if case == "m=0":
        return np.zeros(0), 4
    if case == "m=1":
        return np.asarray([5]), 1
    # the training path's deepest dedup: 39,208 seeds x (1 + 32) slots
    m = 1293864
    ids = rng.integers(0, 262144, m)
    ids[rng.random(m) < 0.5] = INVALID
    return ids, 262144


@pytest.mark.parametrize("case", [
    "tile-1", "tile", "tile+1", "run-over-3-tiles", "cap-mid-tile", "invalid-tail",
    "cap-past-last-tile", "one-tile-wide-cap", "m=0", "m=1", "m=1293864",
])
def test_unique_compact_tiles_match_plain(cuda, case):
    ids_np, cap = _dedup_case(case)
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(cuda)
    s, order = torch.sort(ids)
    identity = torch.arange(len(s), device=cuda)  # the inverse in sorted order
    reset_launches()
    for o in (identity, order):
        got, want = unique_compact_cuda(s, cap, o), unique_compact_sorted_ref(s, cap, o)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), o is order
    assert LAUNCHES["unique_compact"] == 2
    if len(s) > 1:  # a view 4 bytes off a 16-byte boundary takes the scalar loads
        o = identity[: len(s) - 1]
        got, want = unique_compact_cuda(s[1:], cap, o), unique_compact_sorted_ref(s[1:], cap, o)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = unique_with_inverse(ids, cap)
    want = unique_with_inverse_ref(ids.cpu(), cap)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    torch.cuda.synchronize()


def _probe_case(case):
    """(tags, sets, ids) numpy arrays of one ``tag_probe`` case.  The three
    ``S=..-W=..-n=..`` cases draw, in turn from one generator, dense ids in
    0..98 (sets often hold an id twice); the others plant 50% hits among
    sparse ids, and a ``duplicates`` case copies each set's first W // 2
    tags into its last W // 2 ways."""
    dense = [(256, 8, 4000), (64, 1, 100), (16, 4, 0)]
    if case in [f"S={S}-W={W}-n={n}" for S, W, n in dense]:
        rng = np.random.default_rng(1)
        for S, W, n in dense:
            tags = rng.integers(0, 99, (S, W)).astype(np.int32)
            sets = rng.integers(0, S, n).astype(np.int32)
            ids = rng.integers(-1, 99, n).astype(np.int32)
            if case == f"S={S}-W={W}-n={n}":
                return tags, sets, ids
    rng = np.random.default_rng(len(case))
    S, n = 512, 0 if case == "n=0" else 3000
    W = int(case.split("=")[-1]) if "W=" in case else 8
    tags = rng.integers(0, 5000, (S, W)).astype(np.int32)
    tags[rng.random((S, W)) < 0.3] = INVALID
    if case.startswith("duplicates"):
        tags[:, W - W // 2:] = tags[:, :W // 2]
    sets = rng.integers(0, S, n).astype(np.int32)
    ids = rng.integers(0, 5000, n).astype(np.int32)
    hit = rng.random(n) < 0.5
    ids[hit] = tags[sets[hit], rng.integers(0, W, int(hit.sum()))]
    ids[rng.random(n) < 0.2] = -1
    if case == "minus-one-ids":
        ids[:] = -1
    return tags, sets, ids


@pytest.mark.parametrize("case", [
    "S=256-W=8-n=4000", "S=64-W=1-n=100", "S=16-W=4-n=0",
    "W=1", "W=3", "W=4", "W=8", "W=16", "duplicates", "duplicates-W=3",
    "duplicates-W=16", "duplicates-offset-view-W=8", "minus-one-ids",
    "offset-view-W=8", "offset-view-W=4", "offset-view-W=3", "n=0",
])
def test_tag_probe_matches_plain(cuda, case):
    """The first matching way, from one launch, equal to the plain version
    on the card and on the CPU; a tag view that is not 16-byte aligned
    takes the generic kernel, and a set holding an id twice gives the
    first way."""
    tags_np, sets_np, ids_np = _probe_case(case)
    tags = torch.from_numpy(tags_np).to(cuda)
    if "offset-view" in case:  # tag rows 4 bytes past a 16-byte boundary
        buf = torch.zeros(tags.numel() + 1, dtype=torch.int32, device=cuda)
        buf[1:] = tags.reshape(-1)
        tags = buf[1:].view(tags.shape)
        assert tags.data_ptr() % 16 == 4
    sets, ids = torch.from_numpy(sets_np).to(cuda), torch.from_numpy(ids_np).to(cuda)
    reset_launches()
    got = tag_probe(tags, sets, ids)
    assert LAUNCHES.get("tag_probe", 0) == (1 if len(ids_np) else 0)
    assert torch.equal(got, probe_ref(tags, sets, ids))
    assert torch.equal(got.cpu(), probe_ref(*(torch.from_numpy(a) for a in
                                              (tags_np, sets_np, ids_np))))
    if case.startswith("duplicates"):  # hits on a copied tag, never its second way
        h = tags_np.shape[1] // 2
        assert bool(((got >= 0) & (got < h)).any()) and bool((got < tags_np.shape[1] - h).all())
    torch.cuda.synchronize()


def test_served_trace_matches_cpu(cuda):
    ds = make_recsys(num_users=4096, num_items=512, edges_per_user=8,
                     feature_dim=16, max_degree=64, seed=0, device="cpu")
    cfg = GNNConfig(num_layers=2, in_dim=16, hidden_dim=32, num_classes=8)
    model = init_gnn(cfg, seed=0, device="cpu")
    trace = poisson_trace(200, 2000.0, ds.user_ids, seed=3)
    serve_cfg = ServeConfig(plan_backend="fused")
    reset_launches()
    card = GNNServer(ds.graph, ds.features, cfg, model, serve_cfg, device=cuda)
    got = card.serve_trace(trace)
    assert all(LAUNCHES.get(k, 0) > 0 for k in ("frontier_gather", "unique_compact", "tag_probe"))
    cpu_model = init_gnn(cfg, seed=0, device="cpu")
    want = GNNServer(ds.graph, ds.features, cfg, cpu_model, serve_cfg,
                     device="cpu").serve_trace(trace)
    assert (got.fetched_rows, got.requested_rows, got.cache_hits) == (
        want.fetched_rows, want.requested_rows, want.cache_hits)
    for a, b in zip(got.batches, want.batches):
        assert (a.bucket, a.num_unique, a.edges, a.fetched_rows) == (
            b.bucket, b.num_unique, b.edges, b.fetched_rows)
    for a, b in zip(got.served, want.served):
        np.testing.assert_allclose(a.pred, b.pred, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("V,d,n", [(5000, 64, 20000), (300, 7, 1000), (64, 256, 1), (10, 4, 0)])
def test_gather_matches_plain(cuda, V, d, n):
    rng = np.random.default_rng(V + d)
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32)).to(cuda)
    ids = rng.integers(-3, V + 3, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = INVALID
    ids = torch.from_numpy(ids).to(cuda)
    assert torch.equal(gather(table, ids), gather_ref(table, ids))
    # an unaligned table view takes the scalar path
    if d % 4 == 0 and V > 1:
        view = table.reshape(-1)[1 : 1 + (V - 1) * d].reshape(V - 1, d)
        assert torch.equal(gather(view, ids), gather_ref(view, ids))
    torch.cuda.synchronize()


def _spmm_inputs(S, d, n, w, seed, device):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.standard_normal((S, d)).astype(np.float32)).to(device)
    idx = rng.integers(-1, S, (n, w)).astype(np.int32)
    mask = (rng.random((n, w)) < 0.4) & (idx >= 0)
    idx[rng.random((n, w)) < 0.05] = S + 5  # masked-out junk must be ignored
    mask &= idx < S
    return src, torch.from_numpy(idx).to(device), torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("S,d,n,w", [
    (262144, 64, 39208, 32), (26136, 256, 1584, 32), (1056, 256, 64, 32), (50, 3, 7, 1),
    (10, 8, 0, 4),
])
def test_spmm_forward_matches_plain(cuda, S, d, n, w):
    src, idx, mask = _spmm_inputs(S, d, n, w, S + n, cuda)
    for mean, fn in ((False, spmm_sum), (True, spmm_mean)):
        assert torch.equal(fn(src, idx, mask), spmm_ref(src, idx, mask, mean=mean)), mean
    torch.cuda.synchronize()


def _same_bits(a, b):
    """Equal values, and equal int32 views, so the sign of a zero counts."""
    return torch.equal(a, b) and torch.equal(a.view(torch.int32), b.view(torch.int32))


# (S, d, n, w) of each forward edge case
SPMM_FWD_CASES = {
    "padding-90": (262144, 64, 39208, 32),  # layer 2's layout: >= 90% of rows empty
    "serve-w64": (3600, 64, 480, 64),        # serving's row width: two rounds of 32
    "d=3": (500, 3, 300, 32),                # scalar columns
    "d=256": (26136, 256, 1584, 32),         # two float4s per lane
    "unaligned-src": (700, 64, 200, 32),     # a view 4 bytes off: scalar, two per lane
    "all-masked-rows": (1056, 256, 64, 32),  # every slot of every 4th row masked
    "special-values": (2000, 64, 600, 32),   # -0.0, inf, NaN where only masked-out slots point
}


@pytest.mark.parametrize("case", list(SPMM_FWD_CASES))
def test_spmm_forward_edge_cases(cuda, case):
    """The forward equals its plain version bit for bit (int32 views too) on
    the card and on the CPU, in both modes, with one launch a call: rows
    with no masked slot, every slot masked, w > 32, d = 3 and 256, an
    unaligned source, and -0.0 / inf / NaN in source rows that only
    masked-out slots point at (a sum of -0.0 rows is +0.0)."""
    S, d, n, w = SPMM_FWD_CASES[case]
    rng = np.random.default_rng(len(case))
    src = rng.standard_normal((S + 1, d)).astype(np.float32)
    idx = rng.integers(-1, S, (n, w)).astype(np.int32)
    mask = (rng.random((n, w)) < 0.4) & (idx >= 0)
    if case == "padding-90":
        mask[rng.random(n) < 0.95] = False
        assert (~mask.any(axis=1)).mean() >= 0.9
    if case == "all-masked-rows":
        idx[::4] = rng.integers(0, S, (len(idx[::4]), w))
        mask[::4] = True
    if case == "special-values":
        # masked slots read odd rows, masked-out slots even rows; even rows
        # hold -0.0, inf, -inf and NaN, and odd rows below 200 hold -0.0
        idx = np.where(mask, idx | 1, idx & ~1).clip(0, S - 1).astype(np.int32)
        src[0:S:2] = np.resize(np.array([-0.0, np.inf, -np.inf, np.nan], np.float32),
                               src[0:S:2].shape)
        src[1:200:2] = -0.0
        idx[:50] = np.where(mask[:50], rng.integers(0, 100, (50, w)) | 1, 0)  # -0.0 rows only
    table = torch.from_numpy(src).to(cuda)
    if case == "unaligned-src":  # 4 bytes past a 16-byte boundary
        table = table.reshape(-1)[1 : 1 + S * d].reshape(S, d)
    else:
        table = table[:S]
    assert (table.data_ptr() % 16 != 0) == (case == "unaligned-src")
    idx_t, mask_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    for mean in (False, True):
        reset_launches()
        got = spmm_cuda(table, idx_t, mask_t, mean)
        assert LAUNCHES["spmm"] == 1
        want = spmm_ref(table, idx_t, mask_t, mean=mean)
        assert _same_bits(got, want), mean
        assert _same_bits(got.cpu(), spmm_ref(table.cpu(), idx_t.cpu(), mask_t.cpu(), mean=mean))
        if case == "special-values":
            assert bool(torch.isfinite(got).all())
            assert not bool(torch.signbit(got[:50]).any())  # +0.0, never -0.0
    torch.cuda.synchronize()


@pytest.mark.parametrize("S,d,n,w", [
    (262144, 64, 39208, 32), (26136, 256, 1584, 32), (1056, 256, 64, 32), (50, 3, 7, 1),
    (10, 8, 0, 4),
])
def test_spmm_backward_matches_plain(cuda, S, d, n, w):
    src, idx, mask = _spmm_inputs(S, d, n, w, S * w, cuda)
    g = torch.randn((n, d), generator=torch.Generator().manual_seed(S)).to(cuda)
    for mean, fn in ((False, spmm_sum), (True, spmm_mean)):
        reset_launches()
        s = src.clone().requires_grad_()
        (got,) = torch.autograd.grad(fn(s, idx, mask), s, g)
        if n:
            assert LAUNCHES["spmm"] == 1 and LAUNCHES["spmm_backward"] == 1
        assert torch.equal(got, spmm_backward_ref(g, idx, mask, S, mean=mean)), mean
        again = spmm_backward_cuda(g, idx, mask, S, mean)
        assert torch.equal(again, got), mean  # the same bits from call to call
        cpu = src.cpu().requires_grad_()
        (ref,) = torch.autograd.grad(fn(cpu, idx.cpu(), mask.cpu()), cpu, g.cpu())
        assert torch.equal(got.cpu(), ref), mean
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["hub", "hub-300", "all-masked", "S=1"])
def test_spmm_backward_edge_cases(cuda, case):
    """Runs longer than a warp (a hub every slot reads: 3000 and 300 entries,
    sorted in place by one warp), no masked slot at all, and a single source
    row; two calls give the same bits."""
    rng = np.random.default_rng(len(case))
    S, d, n, w = {"hub": (300, 64, 1500, 2), "hub-300": (40, 256, 300, 1),
                  "all-masked": (1000, 256, 64, 32), "S=1": (1, 5, 100, 4)}[case]
    idx = rng.integers(-1, S + 2, (n, w)).astype(np.int32)
    mask = rng.random((n, w)) < 0.7
    if case.startswith("hub"):
        idx[:], mask[:] = 7, True
    if case == "all-masked":
        mask[:] = False
    idx, mask = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    for mean in (False, True):
        got = spmm_backward_cuda(g, idx, mask, S, mean)
        assert torch.equal(got, spmm_backward_cuda(g, idx, mask, S, mean)), mean
        assert torch.equal(got, spmm_backward_ref(g, idx, mask, S, mean=mean)), mean
        if case == "all-masked":
            assert not bool(got.any())
    torch.cuda.synchronize()


# (S, d, n) of the mean-mode rows at R-GCN's widths: plan layers 1 and 2
SPMM_MEAN_WIDE = {"d=1024": (26136, 1024, 1584), "d=768": (60000, 768, 9000)}


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset-view"])
@pytest.mark.parametrize("case", list(SPMM_MEAN_WIDE))
def test_spmm_mean_wide_matches_plain(cuda, case, offset):
    """The mean mode at R-GCN's widths (6 and 8 passes of a 32-lane group
    over d's float4s): forward and backward equal to their plain versions
    bit for bit (int32 views too) on one relation's mask, one launch each,
    the backward the same from call to call; on a 16-byte aligned source and
    gradient, and on views 4 bytes past an allocation's start (the scalar
    kernels)."""
    S, d, n = SPMM_MEAN_WIDE[case]
    w = 32
    rng = np.random.default_rng(d)
    src, idx, mask = _spmm_inputs(S, d, n, w, d + n, cuda)
    mask &= torch.from_numpy(rng.integers(0, 4, (n, w)) == 1).to(cuda)  # one relation
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    if offset:
        src = torch.cat([src.new_zeros(1), src.reshape(-1)])[1:].view(S, d)
        g = torch.cat([g.new_zeros(1), g.reshape(-1)])[1:].view(n, d)
    assert (src.data_ptr() % 16 != 0) == offset and (g.data_ptr() % 16 != 0) == offset
    reset_launches()
    got = spmm_cuda(src, idx, mask, True)
    assert LAUNCHES["spmm"] == 1
    assert _same_bits(got, spmm_ref(src, idx, mask, mean=True))
    grad = spmm_backward_cuda(g, idx, mask, S, True)
    assert LAUNCHES["spmm_backward"] == 1
    assert _same_bits(grad, spmm_backward_ref(g, idx, mask, S, mean=True))
    assert _same_bits(spmm_backward_cuda(g, idx, mask, S, True), grad)
    torch.cuda.synchronize()


def test_kernels_reject_bad_inputs(cuda):
    table = torch.zeros((8, 4), device=cuda)
    ids = torch.zeros(6, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        gather_cuda(table.double(), ids)
    with pytest.raises(ValueError, match="dtype"):
        gather_cuda(table, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather_cuda(table.t(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather_cuda(table, torch.zeros(12, dtype=torch.int32, device=cuda)[::2])
    src, idx, mask = _spmm_inputs(8, 4, 6, 3, 0, cuda)
    with pytest.raises(ValueError, match="dtype"):
        spmm_cuda(src.half(), idx, mask, mean=False)
    with pytest.raises(ValueError, match="dtype"):
        spmm_cuda(src, idx, mask.to(torch.uint8), mean=False)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_cuda(src, idx.t(), mask.t(), mean=False)
    grad = torch.zeros((6, 4), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        spmm_backward_cuda(grad, idx.long(), mask, 8, mean=True)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_backward_cuda(grad.t().contiguous().t(), idx, mask, 8, mean=True)


@pytest.mark.parametrize("n,w,h,frac", [
    (39208, 32, 4, 0.01),   # the GAT training path's layer 2 (mostly padding)
    (1584, 32, 4, 0.6), (64, 32, 4, 0.9), (480, 64, 4, 0.5), (300, 70, 1, 0.5),
    (100, 5, 0, 0.5), (0, 32, 4, 0.5),
    (39208, 32, 4, 0.0),    # a layer that is all padding
    (1584, 32, 8, 0.6),     # 8 heads: two 16-byte accesses a slot
    (480, 16, 4, 0.5),      # half a warp's lanes past w
    (200, 32, 4, "last"),   # rows whose one valid slot is the last lane's
    (300, 70, 2, 0.5), (96, 33, 3, "last"),
])
def test_seg_softmax_matches_plain(cuda, n, w, h, frac):
    rng = np.random.default_rng(n + w)
    shape = (n, w, h) if h else (n, w)
    e = torch.from_numpy((3 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    if frac == "last":
        mask_np = np.zeros((n, w), bool)
        mask_np[:, w - 1] = True
    else:
        mask_np = rng.random((n, w)) < frac
    mask_np[: n // 8] = False  # all-masked rows
    mask = torch.from_numpy(mask_np).to(cuda)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    m = (mask[..., None] if h else mask).expand(shape)
    reset_launches()
    x = e.clone().requires_grad_()
    alpha = seg_softmax(x, mask)
    (grad,) = torch.autograd.grad(alpha, x, g)
    if n:
        assert LAUNCHES["seg_softmax"] == 1 and LAUNCHES["seg_softmax_backward"] == 1
    want = seg_softmax_ref(e, mask)
    torch.testing.assert_close(alpha.detach(), want, rtol=0, atol=1e-6)
    assert bool((alpha.detach()[~m] == 0).all())
    want_g = seg_softmax_backward_ref(alpha.detach(), g, mask)
    atol = 1e-6 * float(g.abs().max()) if n else 0.0
    torch.testing.assert_close(grad, want_g, rtol=0, atol=atol)
    assert bool((grad[~m] == 0).all())
    # and against the CPU's plain versions
    torch.testing.assert_close(alpha.detach().cpu(), seg_softmax_ref(e.cpu(), mask.cpu()),
                               rtol=0, atol=1e-6)
    torch.cuda.synchronize()


@pytest.mark.parametrize("R,num_edges,max_deg", [
    (39208, 1254656, 1), (1584, 50688, 32), (8, 512, 8), (1, 300, 3), (0, 5, 0), (50, 0, 3),
])
def test_expand_indptr_matches_plain(cuda, R, num_edges, max_deg):
    deg = np.random.default_rng(R).integers(0, max_deg + 1, size=R)
    iptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)).to(cuda)
    reset_launches()
    got = expand_indptr(iptr, num_edges)
    assert LAUNCHES.get("expand_indptr", 0) == (1 if num_edges else 0)
    assert torch.equal(got, expand_indptr_ref(iptr, num_edges))
    assert torch.equal(got.cpu(), expand_indptr_ref(iptr.cpu(), num_edges))
    torch.cuda.synchronize()


def _indptr_case(case):
    """(indptr, num_edges) of one ``expand_indptr`` edge case."""
    rng = np.random.default_rng(len(case))
    if case == "empty-runs":  # 40 rows with edges among 50,000
        deg = np.zeros(50000, np.int64)
        deg[rng.choice(50000, 40, replace=False)] = rng.integers(1, 20, 40)
    elif case == "hub-300":  # one row longer than many threads' runs
        deg = rng.integers(0, 3, 500)
        deg[250] = 300
    elif case in ("tail-not-4", "edges-equal-total", "first-above-0"):
        deg = rng.integers(0, 6, 1001)
        deg[-1] += (1 - deg.sum()) % 4  # a total one past a multiple of 4
    else:  # R = 0
        deg = np.zeros(0, np.int64)
    iptr = np.concatenate([[0], np.cumsum(deg)])
    total = int(iptr[-1])
    if case == "first-above-0":
        iptr = iptr + 7
    num_edges = {"edges-equal-total": total, "tail-not-4": 4 * (total // 4) + 4 * 37 + 3,
                 "R=0": 13, "first-above-0": total + 10}.get(case, total + 1001)
    if case == "edges-equal-total":
        assert num_edges % 4 != 0
    return torch.from_numpy(iptr.astype(np.int32)), num_edges


@pytest.mark.parametrize("case", ["empty-runs", "hub-300", "tail-not-4", "edges-equal-total",
                                  "first-above-0", "R=0"])
def test_expand_indptr_edge_cases(cuda, case):
    """Equal to the plain version on the card and the CPU, one launch: long
    runs of empty rows, a 300-slot hub row, a tail of num_edges % 4 slots,
    num_edges == indptr[R], an indptr that starts above 0, and R = 0."""
    iptr, num_edges = _indptr_case(case)
    reset_launches()
    got = expand_indptr(iptr.to(cuda), num_edges)
    assert LAUNCHES["expand_indptr"] == 1
    assert torch.equal(got, expand_indptr_ref(iptr.to(cuda), num_edges))
    assert torch.equal(got.cpu(), expand_indptr_ref(iptr, num_edges))
    torch.cuda.synchronize()


def test_gat_and_coo_kernels_reject_bad_inputs(cuda):
    e = torch.zeros((6, 3, 2), device=cuda)
    mask = torch.ones((6, 3), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        seg_softmax_cuda(e.double(), mask)
    with pytest.raises(ValueError, match="dtype"):
        seg_softmax_cuda(e, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        seg_softmax_cuda(e.transpose(0, 2).contiguous().transpose(0, 2), mask)
    with pytest.raises(ValueError, match="mask"):
        seg_softmax_cuda(e[:, :2].contiguous(), mask)
    with pytest.raises(ValueError, match="alpha"):
        seg_softmax_backward_cuda(e, e[..., :1].contiguous(), mask)
    # a contiguous view 4 bytes past a 16-byte boundary: the kernels take
    # 16-byte-aligned floats only, and the autograd op copies such a view
    shifted = torch.randn(6 * 3 * 2 + 1, device=cuda)[1:].view(6, 3, 2)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        seg_softmax_cuda(shifted, mask)
    with pytest.raises(ValueError, match="aligned"):
        seg_softmax_backward_cuda(e, shifted, mask)
    torch.testing.assert_close(seg_softmax(shifted, mask), seg_softmax_ref(shifted, mask),
                               rtol=0, atol=1e-6)
    iptr = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        expand_indptr_cuda(iptr.long(), 8)
    with pytest.raises(ValueError, match="indptr"):
        expand_indptr_cuda(iptr[:0], 8)


@pytest.mark.parametrize("model", ["gcn", "gat", "sage", "rgcn"])
def test_cooperative_training_matches_cpu(cuda, model):
    """A few cooperative steps on the card and on the CPU: equal plans
    (relation ids too) and losses within ``rtol=1e-4``; GraphSAGE samples
    with NS, R-GCN trains on a graph with 4 relations."""
    ds = SyntheticGraphDataset(rmat_graph(scale=11, edge_factor=8, max_degree=16,
                                          num_edge_types=4 if model == "rgcn" else 1,
                                          device="cpu"), feature_dim=16, num_classes=4)
    cfg = GNNConfig(model=model, num_layers=2, in_dim=16, hidden_dim=32, num_classes=4,
                    num_heads=2, num_relations=4)
    tc = TrainConfig(num_pes=4, local_batch=16, fanout=5, num_steps=3, kappa=4,
                     eval_every=0, plan_backend="fused",
                     sampler="ns" if model == "sage" else "labor0")
    plans = {}
    runs = {}
    for dev in (cuda, "cpu"):
        net = init_gnn(cfg, seed=0, device="cpu")
        reset_launches()
        runs[str(dev)] = train_gnn(
            ds, cfg, tc, model=net, device=dev,
            on_step=lambda step, plan, d=str(dev): plans.setdefault(d, []).append(plan))
        if dev is cuda:
            agg = ("seg_softmax", "seg_softmax_backward") if model == "gat" else (
                "spmm", "spmm_backward")
            for k in ("frontier_gather", "unique_compact", "gather", *agg):
                assert LAUNCHES.get(k, 0) > 0, k
    for a, b in zip(plans["cuda"], plans["cpu"]):
        for la, lb in zip(a.layers, b.layers):
            for name in ("seeds", "self_idx", "nbr_idx", "mask", "slot_to_tilde",
                         "req_idx", "tilde_ids", "etypes"):
                if name == "etypes" and model != "rgcn":
                    assert la.etypes is None and lb.etypes is None
                    continue
                assert torch.equal(getattr(la, name).cpu(), getattr(lb, name)), name
        assert torch.equal(a.input_ids.cpu(), b.input_ids)
    np.testing.assert_allclose(runs["cuda"].losses, runs["cpu"].losses, rtol=1e-4)


@pytest.mark.parametrize("name", ["ns", "rw", "full", "labor*"])
def test_samplers_on_card_match_cpu(cuda, name):
    """Layer samples on the card equal the CPU's (``etypes`` too), under both
    neighbor-table backends, at kappa = 4 (c > 0 from step 1)."""
    from repro_torch.core import DependentRNG, make_sampler

    g_cpu = rmat_graph(scale=11, edge_factor=8, max_degree=32, num_edge_types=4, device="cpu")
    g = g_cpu.to(cuda)
    rng = np.random.default_rng(11)
    seeds = np.sort(rng.choice(g.num_vertices, 500, replace=False)).astype(np.int32)
    seeds[-20:] = INVALID
    s_cpu = torch.from_numpy(seeds)
    for step in range(3):
        state = DependentRNG(0, 4, step).state
        for layer in (0, 1):
            want = make_sampler(name, fanout=5).sample_layer(g_cpu, s_cpu, state, layer)
            for backend in ("reference", "fused"):
                got = make_sampler(name, fanout=5, backend=backend).sample_layer(
                    g, s_cpu.to(cuda), state, layer)
                for f in ("seeds", "nbr", "mask", "etypes"):
                    a, b = getattr(got, f), getattr(want, f)
                    assert (a is None) == (b is None), f
                    if a is not None:
                        assert torch.equal(a.cpu(), b), (f, step, layer, backend)
    assert int(want.mask.sum()) > 0
    torch.cuda.synchronize()


def test_layer_to_coo_matches_cpu(cuda):
    ds = SyntheticGraphDataset(rmat_graph(scale=11, edge_factor=8, max_degree=16,
                                          device="cpu"), feature_dim=16, num_classes=4)
    tc = TrainConfig(num_pes=4, local_batch=16, fanout=5, num_steps=1, kappa=4,
                     eval_every=0, plan_backend="fused")
    plans = {}
    for dev in (cuda, "cpu"):
        engine = MinibatchEngine.from_config(ds.graph, tc.engine_config(2), dataset=ds,
                                             device=dev)
        plans[str(dev)] = engine.plan_at(0)
    reset_launches()
    for la, lb in zip(plans["cuda"].layers, plans["cpu"].layers):
        blk_a, blk_b = (MinibatchLayer(x.seeds[0], x.self_idx[0], x.nbr_idx[0], x.mask[0], None)
                        for x in (la, lb))
        cap = blk_a.mask.numel()
        got = layer_to_coo(blk_a, cap, backend="fused")
        want = layer_to_coo(blk_b, cap, backend="reference")
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert LAUNCHES.get("expand_indptr", 0) == len(plans["cpu"].layers)
    torch.cuda.synchronize()
