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
losses, and the NS, RW, full and LABOR-* samplers the same samples.  The
stateful ``ClockCache`` must keep the CPU's CLOCK state over a κ trace
(one ``tag_probe`` launch per access), and ``engine.stream`` with
features through the tiered cache give the CPU's items and counters.
The analyzer's contracts and trace passes run on the card.  Each of the
LM pool's ten architectures (reduced) gives the CPU's logits, caches,
greedy tokens and MoE routes on the card; a reduced train step gives the
CPU's loss, gradients and losses, and the cooperative embedding's kernel
route gives ``embed[tokens]`` bit for bit.  The compiled programs replay
against their own bodies run eagerly: ``plan_at``, the server's buckets,
the GNN train step, the tiered store, LM decode and the LM train step,
and the shard executor's plan and train step on a one-rank NCCL group.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_config
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


def _gather_ids(kind, V, n, rng):
    """``mixed``: ids in [-3, V + 3) with 10% INVALID; ``head``: a
    sorted-unique head of 2% of ``n`` and an INVALID tail, as a plan's input
    ids; ``padding``: all INVALID; ``valid``: all in [0, V);
    ``interleaved``: half of them INVALID, anywhere; ``out-of-range``:
    negative and >= V ids among valid ones and INVALID."""
    if kind == "mixed":
        ids = rng.integers(-3, V + 3, n).astype(np.int32)
        ids[rng.random(n) < 0.1] = INVALID
    elif kind == "head":
        head = np.sort(rng.choice(V, n // 50, replace=False))
        ids = np.concatenate([head, np.full(n - len(head), INVALID)])
    elif kind == "padding":
        ids = np.full(n, INVALID)
    else:
        ids = rng.integers(0, V, n)
        if kind == "interleaved":
            ids[rng.random(n) < 0.5] = INVALID
        elif kind == "out-of-range":
            pick = rng.random(n)
            ids[pick < 0.2] = rng.integers(-2**31, 0, int((pick < 0.2).sum()))
            ids[(pick >= 0.2) & (pick < 0.4)] = rng.integers(
                V, 2**31 - 1, int(((pick >= 0.2) & (pick < 0.4)).sum()))
            ids[pick >= 0.9] = INVALID
    return torch.from_numpy(np.asarray(ids, np.int32))


@pytest.mark.parametrize("V,d,n,kind", [
    pytest.param(5000, 64, 20000, "mixed", id="5000-64-20000"),
    pytest.param(300, 7, 1000, "mixed", id="300-7-1000"),
    pytest.param(64, 256, 1, "mixed", id="64-256-1"),
    pytest.param(10, 4, 0, "mixed", id="10-4-0"),
    # the R-GCN's width: a plan's sorted-unique owned ids, then 98% padding
    pytest.param(20000, 768, 50000, "head", id="20000-768-50000-head"),
    pytest.param(2000, 768, 3000, "padding", id="2000-768-3000-padding"),
    pytest.param(2000, 768, 3000, "valid", id="2000-768-3000-valid"),
    pytest.param(300, 768, 0, "mixed", id="300-768-0"),
    pytest.param(1000, 768, 2000, "out-of-range", id="1000-768-2000-out-of-range"),
    pytest.param(5000, 64, 20000, "interleaved", id="5000-64-20000-interleaved"),
    # one float4 a row, and the generic (float) path
    pytest.param(500, 4, 3000, "mixed", id="500-4-3000"),
    pytest.param(500, 6, 3000, "mixed", id="500-6-3000"),
])
def test_gather_matches_plain(cuda, V, d, n, kind):
    rng = np.random.default_rng(V + d)
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32)).to(cuda)
    ids = _gather_ids(kind, V, n, rng).to(cuda)
    reset_launches()
    got = gather(table, ids)
    assert LAUNCHES.get("gather", 0) == (1 if n else 0)
    assert torch.equal(got, gather_ref(table, ids))
    # an unaligned table view takes the float path
    if d % 4 == 0 and V > 1:
        view = table.reshape(-1)[1 : 1 + (V - 1) * d].reshape(V - 1, d)
        assert view.data_ptr() % 16 == 4
        assert torch.equal(gather(view, ids), gather_ref(view, ids))
    torch.cuda.synchronize()


def test_gather_output_past_2_31_elements(cuda):
    """An output of more than 2**31 floats (d = 1,024, n = 2**21 + 64, 8.6
    GB): rows past the 2**31st element land where they belong.  Compared
    with the plain version a chunk of rows at a time, so that the
    reference's own memory stays small."""
    V, d, n = 4096, 1024, 2**21 + 64
    rng = np.random.default_rng(31)
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32)).to(cuda)
    ids = rng.integers(0, V, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = INVALID
    ids[-64:] = np.arange(V - 64, V)  # distinct valid rows past element 2**31
    ids = torch.from_numpy(ids).to(cuda)
    reset_launches()
    out = gather(table, ids)
    assert LAUNCHES.get("gather", 0) == 1
    assert out.numel() > 2**31
    chunk = 2**18
    for i in range(0, n, chunk):
        assert torch.equal(out[i : i + chunk], gather_ref(table, ids[i : i + chunk])), i
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


def _kappa_trace(steps, P, n, V, kappa, seed):
    """(P, n) id batches, each id resampled with probability 1/kappa a step,
    about 5% INVALID."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, V, (P, n))
    out = []
    for _ in range(steps):
        cur = np.where(rng.random((P, n)) < 1.0 / kappa, rng.integers(0, V, (P, n)), cur)
        ids = cur.astype(np.int32)
        ids[rng.random((P, n)) < 0.05] = INVALID
        out.append(ids)
    return out


def test_clock_cache_on_card_matches_cpu(cuda):
    """A κ = 8 trace through ``ClockCache`` at 4 PEs on the card and on the
    CPU: per-batch misses and the whole CLOCK state equal after every
    batch, one ``tag_probe`` launch per access."""
    from repro_torch.store import ClockCache

    card = ClockCache(1024, 8, num_pes=4, device=cuda)
    cpu = ClockCache(1024, 8, num_pes=4, device="cpu")
    trace = _kappa_trace(12, 4, 600, 8192, 8, seed=5)
    reset_launches()
    for step, ids in enumerate(trace):
        assert card.access(torch.from_numpy(ids).to(cuda)) == cpu.access(ids), step
        for name in cpu.state._fields:
            assert torch.equal(getattr(card.state, name).cpu(), getattr(cpu.state, name)), (
                name, step)
        assert LAUNCHES.get("tag_probe", 0) == step + 1
    assert card.hits > 0 and card.miss_rate == cpu.miss_rate
    card.reset_stats()
    assert (card.hits, card.misses) == (0, 0)


def test_stream_with_features_on_card_matches_cpu(cuda):
    """``engine.stream(fetch_features=True)`` through the tiered cache, 3
    steps, on the card and on the CPU: seeds, every integer plan leaf and
    the features bit for bit, the cache counters equal; one ``tag_probe``
    launch per step."""
    from repro_torch.engine import CacheConfig, EngineConfig

    ds = SyntheticGraphDataset(rmat_graph(scale=11, edge_factor=8, max_degree=16,
                                          device="cpu"), feature_dim=16, num_classes=4)
    cfg = EngineConfig(mode="cooperative", num_pes=4, local_batch=16, num_layers=2,
                       sampler="labor0", fanout=5, schedule="smoothed", kappa=4,
                       plan_backend="fused", cache=CacheConfig(enabled=True, capacity=256))
    engines = {d: MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device=d)
               for d in ("cuda", "cpu")}
    reset_launches()
    items = {d: list(e.stream(3, prefetch=2, fetch_features=True)) for d, e in engines.items()}
    assert LAUNCHES.get("tag_probe", 0) == 3
    for a, b in zip(items["cuda"], items["cpu"]):
        assert a.step == b.step and np.array_equal(a.seeds, b.seeds)
        assert torch.equal(a.plan.input_ids.cpu(), b.plan.input_ids)
        for la, lb in zip(a.plan.layers, b.plan.layers):
            for name in ("seeds", "self_idx", "nbr_idx", "mask", "slot_to_tilde",
                         "req_idx", "tilde_ids"):
                assert torch.equal(getattr(la, name).cpu(), getattr(lb, name)), name
        assert a.features.is_cuda and torch.equal(a.features.cpu(), b.features)
    ta, tb = engines["cuda"].tiered, engines["cpu"].tiered
    assert (ta.hits, ta.misses, ta.requested, ta.fetched_rows) == (
        tb.hits, tb.misses, tb.requested, tb.fetched_rows)
    assert ta.requested > 0


def test_analysis_contracts_and_trace_on_card(cuda):
    """The analyzer's contracts pass launches every CUDA wrapper on the
    card (RA100 for all seven, no RA107/RA199), and its trace pass runs
    every entry point there (no RA299) with sync-debug warnings counted."""
    from pathlib import Path

    from repro_torch.analysis import run_analysis

    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    reset_launches()
    rep = run_analysis([str(src)], passes=["contracts", "trace"], device=cuda)
    rules = [f.rule for f in rep.findings]
    assert rules.count("RA100") == 7
    assert not {"RA107", "RA199", "RA299"} & set(rules)
    assert all(LAUNCHES.get(k, 0) > 0 for k in (
        "frontier_gather", "unique_compact", "tag_probe", "gather", "spmm", "seg_softmax",
        "expand_indptr"))
    traced = [f for f in rep.findings if f.rule in ("RA200", "RA201", "RA202")]
    assert traced and all(
        c["sync_warnings"] is not None for f in traced for c in f.extra["calls"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_on_card_matches_cpu(cuda, arch):
    """``chip_smoke.py`` phase 11a: the reduced architecture with the same
    weights on the card and the CPU, ``forward_train`` logits and the
    ``prefill_decode`` logits and caches within ``atol=1e-4``, ``pos`` and 8
    greedy tokens equal; for MoE, layer 0's routes equal."""
    import copy

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import (
        forward_train,
        init_decode_state,
        init_lm,
        prefill_decode,
    )
    from repro_torch.models.transformer.moe import route

    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 32 - cfg.num_prefix_tokens))
    prefix = (rng.standard_normal((4, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
              if cfg.num_prefix_tokens else None)
    enc = (rng.standard_normal((4, cfg.enc_len, cfg.d_model)).astype(np.float32)
           if cfg.enc_dec else None)
    x = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    card = init_lm(cfg, seed=0, device=cuda)
    runs = {}
    for dev, model in ((cuda, card), (torch.device("cpu"), copy.deepcopy(card).to("cpu"))):
        t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
        with torch.inference_mode():
            logits, _ = forward_train(model, cfg, t(toks), t(prefix), t(enc))
        state = init_decode_state(cfg, 4, 24, device=dev)
        if cfg.enc_dec:
            state["enc_out"] = t(enc)
        last, state = prefill_decode(model, cfg, state, t(toks[:, :16]))
        # copies: the serve steps below write the state in place
        leaves = [v.clone() for v in [state["pos"]] + [
            layer[part][k] for layer in state["layers"]
            for part in sorted(layer) for k in sorted(layer[part])]]
        serve, lg, gen = make_serve_step(cfg), last, []
        for _ in range(8):
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            gen.append(tok.cpu())
            lg, state = serve(model, state, tok)
        r = route(model.layers[0]["moe"], cfg, t(x)) if cfg.num_experts else None
        runs[dev.type] = ([logits.cpu(), last.cpu()] + [v.cpu() for v in leaves],
                          torch.cat(gen, 1), r)
    (a, gen_a, ra), (b, gen_b, rb) = runs["cuda"], runs["cpu"]
    assert int(a[2]) == int(b[2]) == 16
    for u, v in zip(a[:2] + a[3:], b[:2] + b[3:], strict=True):
        assert float((u - v).abs().max()) <= 1e-4
    assert torch.equal(gen_a, gen_b)
    if ra is not None:
        assert torch.equal(ra.expert.cpu(), rb.expert)
        assert torch.equal(ra.table_tok.cpu(), rb.table_tok)


def test_cooperative_embed_kernel_route_matches_plain(cuda):
    """``chip_smoke.py`` phase 12a/12c: with ``cooperative_embed`` and B·S >
    V, the card's route (``unique_compact`` once, ``gather`` twice a
    forward) gives ``embed[tokens]`` bit for bit, as the plain versions do on
    the card; its gradients match the plain ``embed[tokens]`` route's; a
    bfloat16 table is refused, not rerouted."""
    import copy
    import dataclasses

    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.kernels import KernelContractError
    from repro_torch.launch.steps import lm_loss
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.transformer.model import _embed_tokens

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), cooperative_embed=True)
    toks = torch.as_tensor(synthetic_token_batch(4, 257, cfg.vocab_size, seed=0), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    model = init_lm(cfg, seed=0, device=cuda)
    reset_launches()
    h = _embed_tokens(model, cfg, batch["tokens"])
    assert (LAUNCHES.get("unique_compact", 0), LAUNCHES.get("gather", 0)) == (1, 2)
    ids = batch["tokens"].reshape(-1).to(torch.int32)
    uniq, inv = unique_with_inverse_ref(ids, cfg.vocab_size)
    plain = gather_ref(gather_ref(model.embed.detach(), uniq), inv).reshape(h.shape)
    assert torch.equal(h, plain) and torch.equal(h, model.embed[batch["tokens"]])
    other = copy.deepcopy(model)
    grads = []
    for c, m in ((cfg, model), (dataclasses.replace(cfg, cooperative_embed=False), other)):
        loss = lm_loss(c, m, batch)
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*grads, strict=True):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    with pytest.raises(KernelContractError, match="gather"):
        _embed_tokens(model.to(torch.bfloat16), cfg, batch["tokens"])


def test_lm_train_step_on_card_matches_cpu(cuda):
    """``chip_smoke.py`` phase 12a for one reduced architecture: the same
    weights on the card and the CPU, ``lm_loss`` within ``rtol=1e-5``, each
    parameter's step-0 gradient within 1e-5 of its largest ``|g|``, and 3
    ``make_train_step`` losses within ``rtol=1e-4``, falling."""
    import copy

    from repro_torch.launch.steps import lm_loss, make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import adam_init

    cfg = get_config("gemma2-2b").reduced()
    rng = np.random.default_rng(0)
    arrays = {k: rng.integers(0, cfg.vocab_size, (4, 64)) for k in ("tokens", "labels")}
    card = init_lm(cfg, seed=0, device=cuda)
    runs = {}
    for dev, model in ((cuda, card), (torch.device("cpu"), copy.deepcopy(card).to("cpu"))):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
        loss = lm_loss(cfg, model, batch)
        grads = [g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))]
        # the loss's autograd graph (made on this stream) must be gone before
        # the train step's capture on the card
        loss = float(loss.detach())
        step, opt, losses = make_train_step(cfg), adam_init(model), []
        for _ in range(3):
            model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
        runs[dev.type] = (loss, grads, losses)
    (la, ga, sa), (lb, gb, sb) = runs["cuda"], runs["cpu"]
    assert abs(la - lb) <= 1e-5 * abs(lb)
    for a, b in zip(ga, gb, strict=True):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    np.testing.assert_allclose(sa, sb, rtol=1e-4)
    assert sa[-1] < sa[0]


def _int_leaves(plan) -> dict:
    """Every integer and bool leaf of a plan, by name."""
    out = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in ("seeds", "self_idx", "nbr_idx", "mask", "etypes", "slot_to_tilde",
                     "req_idx", "tilde_ids"):
            if getattr(layer, name, None) is not None:
                out[f"{name}{l}"] = getattr(layer, name)
    return out


def _same_plans(a, b, what):
    la, lb = _int_leaves(a), _int_leaves(b)
    assert set(la) == set(lb), what
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k].cpu(), lb[k].cpu()), (what, k)


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
@pytest.mark.parametrize("schedule,kappa", [("iid", 1), ("smoothed", 16), ("nested", 4)])
def test_plan_at_replays_match_eager_and_cpu(cuda, mode, schedule, kappa):
    """``plan_at`` as one captured program: every replay (steps 0, 1, 15,
    16, 17: c = 0 and a kappa = 16 window edge) equals the eager build of
    the same state and the CPU's plan, seeds included, for all four
    samplers; one capture, and each replay adds the eager build's
    launches and its spans' markers (``plan``, and an id exchange a layer
    when cooperative: two launches a span)."""
    from repro_torch.engine import EngineConfig

    ds = SyntheticGraphDataset(rmat_graph(scale=10, edge_factor=8, max_degree=16,
                                          device="cpu"), feature_dim=8, num_classes=4)
    for sampler in ("labor0", "ns", "rw", "full"):
        cfg = EngineConfig(mode=mode, num_pes=4, local_batch=16, num_layers=2,
                           sampler=sampler, fanout=4, schedule=schedule, kappa=kappa,
                           plan_backend="fused")
        eng = MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device=cuda)
        cpu = MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device="cpu")
        assert eng.captures and not cpu.captures
        eng.plan_at(0)  # the first call: eager, then captured
        prog = eng.plan_program.program(16)
        assert prog is not None and eng.plan_program.compiles == {16: 1}
        for step in (0, 1, 15, 16, 17):
            reset_launches()
            plan, seeds = eng.plan_and_seeds(step)
            replayed = {k: n for k, n in LAUNCHES.items() if n}
            reset_launches()
            eager, eager_seeds = eng.plan_program.fn(eng.step_state(step))
            eager_launches = {k: n for k, n in LAUNCHES.items() if n}
            assert replayed == prog.launches, (sampler, step)
            spans = 1 + (cfg.num_layers if mode == "cooperative" else 0)
            assert replayed.pop("span_marker") == 2 * spans, (sampler, step)
            assert eager_launches == replayed, (sampler, step)
            want, want_seeds = cpu.plan_and_seeds(step)
            what = (sampler, mode, schedule, step)
            assert torch.equal(seeds.cpu(), want_seeds) and torch.equal(eager_seeds.cpu(),
                                                                         want_seeds), what
            _same_plans(plan, eager, what)
            _same_plans(plan, want, what)
        assert eng.plan_program.compiles == {16: 1}
        a, b = eng.plan_at(1), eng.plan_at(1)
        assert a.input_ids.data_ptr() != b.input_ids.data_ptr()  # fresh results
    torch.cuda.synchronize()


def test_served_buckets_replay_match_eager(cuda):
    """``serve.plan`` and ``serve.forward`` captured once per bucket: every
    replay equals the eager functions on the same inputs bit for bit and
    the CPU server's plan; ``compiles`` stays 1 a bucket."""
    ds = make_recsys(num_users=4096, num_items=512, edges_per_user=8,
                     feature_dim=16, max_degree=64, seed=0, device="cpu")
    cfg = GNNConfig(num_layers=2, in_dim=16, hidden_dim=32, num_classes=8)
    serve_cfg = ServeConfig(plan_backend="fused", max_batch=32)
    card = GNNServer(ds.graph, ds.features, cfg, init_gnn(cfg, seed=0, device="cpu"),
                     serve_cfg, device=cuda)
    cpu = GNNServer(ds.graph, ds.features, cfg, init_gnn(cfg, seed=0, device="cpu"),
                    serve_cfg, device="cpu")
    users = np.asarray(ds.user_ids, np.int32)
    for rep in range(3):
        for bucket in card.ladder.buckets:
            seeds = np.sort(users[rep * 7: rep * 7 + bucket])
            plan = card._plan(seeds)
            _same_plans(plan, card._build_plan(torch.from_numpy(seeds).to(cuda)), bucket)
            _same_plans(plan, cpu._plan(seeds), bucket)
            H = card._gather(plan)
            logits = card._forward(plan, H)
            assert torch.equal(logits, card._apply(plan.layers, H)), bucket
    for guard in (card._plan_guard, card._forward_guard):
        assert guard.compiles == {b: 1 for b in card.ladder.buckets}
        assert all(guard.program(b) is not None for b in card.ladder.buckets)
    torch.cuda.synchronize()


def test_stream_dispatches_ahead_with_lazy_seeds(cuda):
    """Items at prefetch 0 and 2 equal, their seeds resolved on first access
    from pinned host memory, equal to the CPU stream's."""
    from repro_torch.engine import EngineConfig

    ds = SyntheticGraphDataset(rmat_graph(scale=10, edge_factor=8, max_degree=16,
                                          device="cpu"), feature_dim=8, num_classes=4)
    cfg = EngineConfig(mode="cooperative", num_pes=4, local_batch=16, num_layers=2,
                       sampler="labor0", fanout=4, schedule="smoothed", kappa=4,
                       plan_backend="fused")
    runs = {}
    for dev, depth in ((cuda, 0), (cuda, 2), ("cpu", 2)):
        eng = MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device=dev)
        runs[str(dev), depth] = list(eng.stream(6, prefetch=depth))
    for a, b, c in zip(runs["cuda", 0], runs["cuda", 2], runs["cpu", 2]):
        assert a.seed_rows._host.is_pinned() and b.seed_rows._event is not None
        assert np.array_equal(b.seeds, c.seeds) and np.array_equal(a.seeds, c.seeds)
        _same_plans(a.plan, c.plan, a.step)
        _same_plans(b.plan, c.plan, b.step)


def test_failed_capture_raises(cuda):
    """A function that reads a device scalar cannot be captured: the
    capture raises ``CaptureError`` and nothing falls back to eager (run in
    a child process: a failed capture can leave the context unusable)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from repro_torch.engine.compiled import CaptureError, CompiledFunction\n"
        "f = CompiledFunction('sync', lambda t: t * int(t.sum()), capture=True)\n"
        "x = torch.ones(4, device='cuda')\n"
        "f(4, x)  # the eager warm-up runs, then the capture raises\n"
        "print('no capture')\n"
    )
    root = Path(__file__).resolve().parents[1]
    env = {**__import__("os").environ, "PYTHONPATH": str(root / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0 and "no capture" not in proc.stdout
    assert "CaptureError" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("model", ["gcn", "gat", "sage", "rgcn"])
@pytest.mark.parametrize("mode", ["cooperative", "independent"])
def test_train_step_program_replays_match_eager(cuda, model, mode):
    """The GNN train step as one captured program against its own body run
    eagerly on the card (``program.fn``) from the same weights: plans bit
    for bit at every step, losses within ``rtol=1e-5`` and weights within
    ``atol=1e-5`` (cuBLAS may take another algorithm inside a graph); one
    capture, and the step's device counter advanced by every replay."""
    from repro_torch.engine import EngineConfig
    from repro_torch.train import adam_init, step_program

    ds = SyntheticGraphDataset(rmat_graph(scale=11, edge_factor=8, max_degree=16,
                                          num_edge_types=4 if model == "rgcn" else 1,
                                          device="cpu"), feature_dim=16, num_classes=4)
    cfg = GNNConfig(model=model, num_layers=2, in_dim=16, hidden_dim=32, num_classes=4,
                    num_heads=2, num_relations=4)
    ecfg = EngineConfig(mode=mode, num_pes=4, local_batch=16, num_layers=2, fanout=5,
                        sampler="ns" if model == "sage" else "labor0", schedule="smoothed",
                        kappa=4, plan_backend="fused")
    labels = torch.as_tensor(ds.labels, device=cuda)
    runs = []
    for captured in (True, False):
        eng = MinibatchEngine.from_config(ds.graph, ecfg, dataset=ds, device=cuda)
        net = init_gnn(cfg, seed=0, device=cuda)
        opt = adam_init(net)
        prog = step_program(eng, cfg, net, opt, labels, 1e-2, with_plan=True)
        assert prog.capture
        run = prog if captured else (lambda key, state, p=prog: p.fn(state))
        out = [run(16, eng.step_state(step)) for step in range(4)]
        runs.append(([float(loss) for loss, _ in out], [plan for _, plan in out],
                     [p.detach().clone() for p in net.parameters()]))
        assert int(opt.step) == 4
        if captured:
            assert prog.captures == {16: 1} and prog.compiles == {16: 1}
    (la, pa, wa), (lb, pb, wb) = runs
    for step, (a, b) in enumerate(zip(pa, pb)):
        _same_plans(a, b, (model, mode, step))
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    for a, b in zip(wa, wb):
        assert float((a - b).abs().max()) <= 1e-5


def test_shard_programs_replay_match_eager_on_nccl(cuda, tmp_path):
    """The shard executor's plan and train-step programs on a one-rank NCCL
    group in this process (a FileStore in ``tmp_path``): each captured once,
    its replays against its own body run eagerly from the same weights:
    plans bit for bit at every step, losses within ``rtol=1e-5`` and
    weights within ``atol=1e-5``; the plans equal the P = 1 SimExecutor's."""
    import gc

    import torch.distributed as dist

    from repro_torch.engine import EngineConfig
    from repro_torch.engine.compiled import tree_map
    from repro_torch.train import adam_init, step_program

    ds = SyntheticGraphDataset(rmat_graph(scale=11, edge_factor=8, max_degree=16,
                                          device="cpu"), feature_dim=16, num_classes=4)
    cfg = GNNConfig(model="gcn", num_layers=2, in_dim=16, hidden_dim=32, num_classes=4)
    ecfg = dict(mode="cooperative", num_pes=1, local_batch=16, num_layers=2, fanout=5,
                schedule="smoothed", kappa=4, plan_backend="fused")
    sim = MinibatchEngine.from_config(ds.graph, EngineConfig(**ecfg), dataset=ds, device=cuda)
    labels = torch.as_tensor(ds.labels, device=cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        runs = []
        for captured in (True, False):
            eng = MinibatchEngine.from_config(ds.graph, EngineConfig(**ecfg, executor="shard"),
                                              dataset=ds, device=cuda)
            runner = eng.shard_runner
            assert eng.captures and runner.captures and runner.plan_program.capture
            net = init_gnn(cfg, seed=0, device=cuda)
            prog = step_program(eng, cfg, net, adam_init(net), labels, 1e-2, with_plan=True)
            run = prog if captured else (lambda key, state, p=prog: p.fn(state))
            out = [run(16, eng.step_state(step)) for step in range(4)]
            runs.append(([float(loss) for loss, _ in out], [plan for _, plan in out],
                         [p.detach().clone() for p in net.parameters()]))
            if captured:
                assert prog.captures == {16: 1} and prog.compiles == {16: 1}
                for step in range(4):  # the plan program: replays against its body
                    _same_plans(runner.plan_at(step), runner._build_at(eng.step_state(step)),
                                ("plan_at", step))
                    _same_plans(runner.plan_at(step), tree_map(lambda t: t[0],
                                                               sim.plan_at(step)),
                                ("sim row 0", step))
                assert runner.plan_program.captures == {16: 1}
            del prog, run, runner, eng
        (la, pa, wa), (lb, pb, wb) = runs
        for step, (a, b) in enumerate(zip(pa, pb)):
            _same_plans(a, b, ("shard step", step))
        np.testing.assert_allclose(la, lb, rtol=1e-5)
        for a, b in zip(wa, wb):
            assert float((a - b).abs().max()) <= 1e-5
        gc.collect()
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def test_lm_train_program_replays_match_eager(cuda):
    """``make_train_step``'s program at a reduced gemma2 on the card: one
    capture for the batch's key, 3 replays against its body run eagerly on
    a copy of the weights: losses within ``rtol=1e-5`` and weights within
    ``atol=1e-5`` (cuBLAS may take another algorithm inside a graph)."""
    import copy

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import adam_init

    cfg = get_config("gemma2-2b").reduced()
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)), device=cuda)
             for k in ("tokens", "labels")}
    model = init_lm(cfg, seed=0, device=cuda)
    eager = copy.deepcopy(model)
    step = make_train_step(cfg)
    opt, e_opt = adam_init(model), adam_init(eager)
    body = step.program(eager).fn
    got, want = [], []
    for _ in range(3):
        model, opt, m = step(model, opt, batch)
        got.append(float(m["loss"]))
        want.append(float(body(list(eager.parameters()), e_opt, batch)))
    prog = step.program(model)
    key = (("tokens", (4, 64)), ("labels", (4, 64)))
    assert prog.capture and prog.captures == {key: 1} and prog.compiles == {key: 1}
    assert not step.program(eager).captures  # its body ran as it is
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(model.parameters(), eager.parameters(), strict=True):
        assert float((a.detach() - b.detach()).abs().max()) <= 1e-5
    assert int(opt.step) == int(e_opt.step) == 3


def test_tiered_store_programs_replay_match_cpu(cuda):
    """The tiered store's two programs captured once a key: every batch's
    rows, CLOCK state and counters equal the CPU store's bit for bit, with
    one sync a gather (the missed ids' read)."""
    from repro_torch.store import TieredFeatureStore

    rng = np.random.default_rng(3)
    V, P, n = 4096, 2, 256
    feats = rng.standard_normal((V, 16)).astype(np.float32)
    card = TieredFeatureStore(feats, capacity=512, ways=8, num_pes=P, device=cuda)
    cpu = TieredFeatureStore(feats, capacity=512, ways=8, num_pes=P, device="cpu")
    trace = _kappa_trace(12, P, n, V, 4, seed=5)
    for step, ids in enumerate(trace):
        got = card.gather(torch.from_numpy(ids).to(cuda))
        want = cpu.gather(torch.from_numpy(ids))
        assert torch.equal(got.cpu(), want), step
        for name, a, b in zip(card.state._fields, card.state, cpu.state):
            assert torch.equal(a.cpu(), b), (step, name)
        assert torch.equal(card.data.cpu(), cpu.data), step
        assert card.fetched_rows == cpu.fetched_rows
    for prog in (card.access_program, card.assemble_program):
        assert prog.captures == {(P, n): 1} and prog.compiles == {(P, n): 1}
    ids = torch.from_numpy(trace[0]).to(cuda)  # the upload syncs: before the window
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            card.gather(ids)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(syncs) == 1, [f"{w.filename}:{w.lineno}" for w in syncs]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_program_replays_match_eager(cuda, arch):
    """The LM decode step as one captured program a batch and cache length
    against ``forward_decode`` run eagerly on the card on a copy of the
    state: logits and state within ``1e-4`` of the largest |logit|, greedy
    tokens equal, one capture; prefill through the program equals stepping
    it bit for bit."""
    import copy

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import (
        decode_program,
        forward_decode,
        init_decode_state,
        init_lm,
        prefill_decode,
    )

    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 12)), device=cuda)
    model = init_lm(cfg, seed=0, device=cuda)

    def fresh():
        st = init_decode_state(cfg, 4, 24, device=cuda)
        if cfg.enc_dec:
            st["enc_out"] = torch.as_tensor(
                np.random.default_rng(2).standard_normal((4, cfg.enc_len, cfg.d_model)),
                dtype=st["enc_out"].dtype, device=cuda)
        return st

    serve = make_serve_step(cfg)
    pre, st_a = prefill_decode(model, cfg, fresh(), toks)
    st_b = fresh()
    for t in range(toks.shape[1]):
        step_logits, st_b = serve(model, st_b, toks[:, t:t + 1])
    assert torch.equal(pre, step_logits)
    leaves = lambda st: [st["pos"]] + [lay[p][k] for lay in st["layers"]  # noqa: E731
                                       for p in sorted(lay) for k in sorted(lay[p])]
    assert all(torch.equal(a, b) for a, b in zip(leaves(st_a), leaves(st_b), strict=True))
    eager_state = copy.deepcopy(st_a)
    lg_c, lg_e = pre, pre.clone()
    scale = float(pre.abs().max())
    for _ in range(6):
        tok_c = torch.argmax(lg_c, -1)[:, None].to(torch.int32)
        tok_e = torch.argmax(lg_e, -1)[:, None].to(torch.int32)
        assert torch.equal(tok_c, tok_e)
        lg_c, st_a = serve(model, st_a, tok_c)
        lg_e, eager_state = forward_decode(model, cfg, eager_state, tok_e)
        assert float((lg_c - lg_e).abs().max()) <= 1e-4 * scale
    for a, b in zip(leaves(st_a), leaves(eager_state), strict=True):
        assert float((a.float() - b.float()).abs().max()) <= 1e-4 * max(
            1.0, float(b.float().abs().max()))
    prog = decode_program(model, cfg)
    key = (4, 24 if any("kv" in lay for lay in st_a["layers"]) else 0)
    assert prog.compiles == {key: 1} and prog.captures == {key: 2}  # two states
