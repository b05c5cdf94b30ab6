"""Port kernels' plain versions vs the JAX package's refs and Pallas kernels.

Each ``repro_torch`` plain version (the CPU path of its wrapper) must be
equal bit for bit to the JAX ``ref``/``probe_ref`` AND to the Pallas
kernel run in interpret mode, on the sweeps of ``tests/test_kernels.py``
and ``tests/test_feature_store.py`` plus overflow, all-INVALID and empty
cases.  Inputs are numpy arrays from seeds handed to both packages.
``spmm`` is the exception: its plain version adds the ``w`` slots in
order where the JAX ones use ``jnp.sum``, so it is held within
``atol=1e-5``, and its backward likewise against ``jax.grad``; so is
``seg_softmax``, whose plain versions add in the CUDA warp's order:
forward within ``atol=1e-6`` of the JAX ref and the Pallas kernel,
backward within ``atol=1e-6`` of ``jax.grad`` of the JAX ref.
``expand_indptr`` is integer and equal bit for bit.

The CUDA kernels themselves are held against these plain versions on
a card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.core import frontier as jfrontier
from repro.core.feature_loader import FeatureStore as JFeatureStore
from repro.data.synthetic import rmat_graph
from repro.kernels.expand_indptr.kernel import expand_indptr_pallas
from repro.kernels.expand_indptr.ref import expand_indptr_ref as j_expand_ref
from repro.kernels.gather.kernel import paged_gather_pallas
from repro.kernels.gather.ref import gather_ref as j_gather_ref
from repro.kernels.seg_softmax.kernel import seg_softmax_pallas
from repro.kernels.seg_softmax.ref import seg_softmax_ref as j_seg_softmax_ref
from repro.kernels.spmm.kernel import spmm_pallas
from repro.kernels.spmm.ref import spmm_ref as j_spmm_ref
from repro.kernels.frontier_gather.kernel import frontier_gather_pallas
from repro.kernels.frontier_gather.ref import frontier_gather_ref as j_frontier_ref
from repro.kernels.unique_compact.kernel import unique_compact_pallas
from repro.kernels.unique_compact.ref import unique_with_inverse_ref as j_unique_ref
from repro.store.kernel import probe_ref as j_probe_ref
from repro.store.kernel import tag_probe_pallas
from repro_torch.kernels.expand_indptr import expand_indptr, expand_indptr_ref
from repro_torch.kernels.frontier_gather import frontier_gather, frontier_gather_ref
from repro_torch.core import FeatureStore
from repro_torch.kernels.gather import gather, gather_ref
from repro_torch.kernels.gather.ops import launch_shape
from repro_torch.kernels.seg_softmax import (
    seg_softmax,
    seg_softmax_backward_ref,
    seg_softmax_ref,
    warp_sum,
)
from repro_torch.kernels.spmm import spmm_backward_ref, spmm_mean, spmm_ref, spmm_sum
from repro_torch.kernels.unique_compact import (
    unique_compact_sorted_ref,
    unique_with_inverse,
    unique_with_inverse_ref,
)
from repro_torch.store import probe_ref, tag_probe

torch.set_num_threads(1)  # the suite runs files in parallel workers

INVALID = np.int32(2**31 - 1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


# ---------------------------------------------------------------------------
# frontier_gather
# ---------------------------------------------------------------------------
def _seeds(n, V, invalid_frac, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, V, size=n).astype(np.int32)
    s[rng.random(n) < invalid_frac] = INVALID
    return s


@pytest.fixture(scope="module")
def degree7_graph():
    """A small graph capped at 7 slots a row: a width that is not a
    multiple of 4, which the CUDA kernel serves with its generic layout."""
    return rmat_graph(scale=8, edge_factor=8, max_degree=7, seed=1)


_FRONTIER_CASES = [  # (graph fixture, n, invalid_frac, seed)
    ("small", 192, 0.15, 3), ("small", 64, 0.0, 4), ("small", 256, 1.0, 5), ("small", 0, 0.0, 6),
    ("degree7", 192, 0.15, 7), ("degree7", 64, 0.0, 8), ("degree7", 100, 1.0, 9),
]


@pytest.mark.parametrize(
    "graph,n,invalid_frac,seed", _FRONTIER_CASES,
    ids=[("" if g == "small" else f"{g}-") + f"{n}-{f}-{s}" for g, n, f, s in _FRONTIER_CASES],
)
def test_frontier_gather_matches_jax_ref_and_pallas(request, graph, n, invalid_frac, seed):
    g = request.getfixturevalue(f"{graph}_graph")
    assert graph != "degree7" or g.max_degree == 7
    seeds = _seeds(n, g.num_vertices, invalid_frac, seed)
    indptr, indices = np.asarray(g.indptr), np.asarray(g.indices)
    nbr, mask = frontier_gather_ref(_t(indptr), _t(indices), _t(seeds), g.max_degree)
    j_nbr, j_mask = j_frontier_ref(g.indptr, g.indices, jnp.asarray(seeds), g.max_degree)
    _eq(nbr, j_nbr)
    _eq(mask, j_mask)
    # the wrapper on CPU tensors is the plain version
    w_nbr, w_mask = frontier_gather(_t(indptr), _t(indices), _t(seeds), g.max_degree)
    assert torch.equal(w_nbr, nbr) and torch.equal(w_mask, mask)
    if n == 0:
        return
    block_n, page = 64, 1024
    seeds_p = np.pad(seeds, (0, (-n) % block_n), constant_values=INVALID)
    ind_p = np.pad(indices, (0, (-g.num_edges) % page), constant_values=INVALID)
    k_nbr = frontier_gather_pallas(
        g.indptr, jnp.asarray(ind_p), jnp.asarray(seeds_p),
        max_degree=g.max_degree, block_n=block_n, page=page, interpret=True,
    )[:n]
    _eq(nbr, k_nbr)


# ---------------------------------------------------------------------------
# unique_compact
# ---------------------------------------------------------------------------
def _padded_ids(m, hi, invalid_frac, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, size=m).astype(np.int32)
    ids[rng.random(m) < invalid_frac] = INVALID
    return ids


@pytest.mark.parametrize("m,cap,hi,block_m", [
    (512, 64, 100, 256),      # heavy duplication, overflow (cap < uniques)
    (512, 600, 100, 256),     # cap > unique count
    (256, 16, 8, 256),        # cap > value range
    (1024, 128, 2**20, 256),  # near-distinct ids, overflow
    (300, 64, 50, 128),       # m not a block multiple
])
def test_unique_compact_matches_jax_ref_and_pallas(m, cap, hi, block_m):
    ids = _padded_ids(m, hi, 0.2, seed=m + cap)
    uniq, inv = unique_with_inverse_ref(_t(ids), cap)
    j_uniq, j_inv = j_unique_ref(jnp.asarray(ids), cap)
    _eq(uniq, j_uniq)
    _eq(inv, j_inv)
    # = the reference frontier algebra
    u0 = jfrontier.unique_padded(jnp.asarray(ids), cap)
    _eq(uniq, u0)
    _eq(inv, jfrontier.lookup(u0, jnp.asarray(ids)))
    # the sorted-input function the CUDA kernel computes = the Pallas kernel
    flat = np.pad(ids, (0, (-m) % block_m), constant_values=INVALID)
    s = np.sort(flat)
    inv_s, uniq_s = unique_compact_sorted_ref(_t(s), cap)
    k_inv_s, k_uniq = unique_compact_pallas(
        jnp.asarray(s), cap, block_m=block_m, interpret=True
    )
    _eq(inv_s, k_inv_s)
    _eq(uniq_s, k_uniq)
    w_uniq, w_inv = unique_with_inverse(_t(ids), cap)
    assert torch.equal(w_uniq, uniq) and torch.equal(w_inv, inv)


def test_unique_compact_all_invalid():
    ids = np.full((256,), INVALID, np.int32)
    uniq, inv = unique_with_inverse_ref(_t(ids), 32)
    j_uniq, j_inv = j_unique_ref(jnp.asarray(ids), 32)
    _eq(uniq, j_uniq)
    _eq(inv, j_inv)
    inv_s, uniq_s = unique_compact_sorted_ref(_t(ids), 32)
    k_inv, k_uniq = unique_compact_pallas(jnp.asarray(ids), 32, block_m=256, interpret=True)
    _eq(inv_s, k_inv)
    _eq(uniq_s, k_uniq)


def test_unique_compact_empty():
    ids = np.zeros((0,), np.int32)
    uniq, inv = unique_with_inverse_ref(_t(ids), 8)
    u0 = jfrontier.unique_padded(jnp.asarray(ids), 8)
    _eq(uniq, u0)
    _eq(inv, jfrontier.lookup(u0, jnp.asarray(ids)))


# ---------------------------------------------------------------------------
# tag_probe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,W,n,page,block_n,seed", [
    (64, 4, 512, 32, 256, 31),
    (128, 8, 1024, 64, 512, 32),
    (32, 1, 256, 32, 256, 33),
    (64, 3, 512, 32, 256, 34),
    (32, 16, 512, 32, 256, 35),
])
def test_tag_probe_matches_jax_ref_and_pallas(S, W, n, page, block_n, seed):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 2000, (S, W)).astype(np.int32)
    tags[rng.random((S, W)) < 0.3] = INVALID
    sets = rng.integers(0, S, n).astype(np.int32)
    ids = np.where(
        rng.random(n) < 0.2, -1, tags[sets, rng.integers(0, W, n)]
    ).astype(np.int32)
    got = probe_ref(_t(tags), _t(sets), _t(ids))
    _eq(got, j_probe_ref(jnp.asarray(tags), jnp.asarray(sets), jnp.asarray(ids)))
    _eq(got, tag_probe_pallas(
        jnp.asarray(tags), jnp.asarray(sets), jnp.asarray(ids),
        block_n=block_n, page=page, interpret=True,
    ))
    assert torch.equal(tag_probe(_t(tags), _t(sets), _t(ids)), got)


def test_tag_probe_duplicate_tags_take_first_way_and_empty():
    tags = np.array([[5, 7, 5, INVALID], [9, 9, 9, 9]], np.int32)
    sets = np.array([0, 0, 1, 1, 0], np.int32)
    ids = np.array([5, 7, 9, -1, 3], np.int32)
    got = probe_ref(_t(tags), _t(sets), _t(ids))
    assert got.tolist() == [0, 1, 0, -1, -1]
    _eq(got, j_probe_ref(jnp.asarray(tags), jnp.asarray(sets), jnp.asarray(ids)))
    e = np.zeros((0,), np.int32)
    _eq(probe_ref(_t(tags), _t(e), _t(e)),
        j_probe_ref(jnp.asarray(tags), jnp.asarray(e), jnp.asarray(e)))


# ---------------------------------------------------------------------------
# gather (feature loading) and spmm (neighbor aggregation)
# ---------------------------------------------------------------------------
def _gather_ids(kind, V, n, rng):
    """``mixed``: ids with 32 INVALID shuffled in; ``head``: a sorted-unique
    head of 2% of ``n`` and an INVALID tail, as a plan's input ids;
    ``padding``: all INVALID."""
    if kind == "mixed":
        ids = np.concatenate([rng.integers(0, V, n - 32), np.full(32, INVALID)])
        rng.shuffle(ids)
    elif kind == "head":
        head = np.sort(rng.choice(V, n // 50, replace=False))
        ids = np.concatenate([head, np.full(n - len(head), INVALID)])
    else:
        ids = np.full(n, INVALID)
    return ids.astype(np.int32)


@pytest.mark.parametrize("V,d,n,page,block_n,kind", [
    pytest.param(2048, 128, 512, 512, 512, "mixed", id="2048-128-512-512-512"),
    pytest.param(4096, 256, 1024, 1024, 512, "mixed", id="4096-256-1024-1024-512"),
    pytest.param(1024, 128, 512, 256, 256, "mixed", id="1024-128-512-256-256"),
    # the R-GCN's width: a plan's sorted-unique owned ids, then padding
    pytest.param(1024, 768, 512, 512, 256, "head", id="1024-768-512-512-256-head"),
    pytest.param(1024, 768, 256, 512, 256, "padding", id="1024-768-256-512-256-padding"),
])
def test_gather_matches_jax_ref_and_pallas(V, d, n, page, block_n, kind):
    rng = np.random.default_rng(V + n)
    tab = rng.standard_normal((V, d)).astype(np.float32)
    ids = _gather_ids(kind, V, n, rng)
    got = gather_ref(_t(tab), _t(ids))
    _eq(got, j_gather_ref(jnp.asarray(tab), jnp.asarray(ids)))
    _eq(got, paged_gather_pallas(jnp.asarray(tab), jnp.asarray(ids), block_n=block_n,
                                 block_d=128, page=page, interpret=True))
    assert torch.equal(gather(_t(tab), _t(ids)), got)
    if kind == "padding":
        assert not got.any()


def test_feature_store_gather_matches_jax_at_rgcn_width():
    """The port's ``FeatureStore.gather`` against the JAX one at d = 768 on
    ``(P, cap)`` input ids as a plan holds them (each PE's sorted-unique
    owned ids, INVALID after), with -2 and ids past V among them: both
    clamp those into [0, V) and zero only INVALID."""
    P, cap, V, d = 4, 64, 300, 768
    rng = np.random.default_rng(7)
    tab = rng.standard_normal((V, d)).astype(np.float32)
    ids = np.full((P, cap), INVALID, np.int32)
    for p in range(P):
        head = np.sort(rng.choice(V, 5 + 9 * p, replace=False))
        ids[p, : len(head)] = head
    ids[1, 40], ids[2, 3], ids[3, 60] = -2, V + 5, -2
    got = FeatureStore(_t(tab)).gather(_t(ids))
    assert got.shape == (P, cap, d)
    _eq(got, JFeatureStore(jnp.asarray(tab)).gather(jnp.asarray(ids)))
    assert torch.equal(got[1, 40], _t(tab[0])) and torch.equal(got[2, 3], _t(tab[V - 1]))


@pytest.mark.parametrize("d,vec4,want", [
    (768, True, (32, 6)), (64, True, (16, 1)), (1024, True, (32, 8)), (4, True, (1, 1)),
    (8192, True, (32, 8)), (6, False, (8, 1)), (7, False, (8, 1)), (768, False, (32, 8)),
    (1, False, (1, 1)),
])
def test_gather_launch_shape(d, vec4, want):
    """Lanes a row (the next power of two >= the row's columns, at most 32)
    and columns a lane per row in flight (at most 8) of the CUDA gather."""
    assert launch_shape(d, vec4) == want


def test_gather_out_of_range_and_empty():
    tab = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[3, -1, 4], [INVALID, 0, -7]], np.int32)
    got = gather(_t(tab), _t(ids))
    _eq(got, j_gather_ref(jnp.asarray(tab), jnp.asarray(ids)))
    assert got.shape == (2, 3, 3) and int((got != 0).any(-1).sum()) == 2
    e = np.zeros((0,), np.int32)
    _eq(gather(_t(tab), _t(e)), j_gather_ref(jnp.asarray(tab), jnp.asarray(e)))


SPMM_SWEEP = [  # (S, d, n, w, block_n, block_d) of tests/test_kernels.py
    (256, 128, 128, 8, 128, 128),
    (512, 256, 256, 12, 128, 128),
    (128, 128, 128, 1, 64, 128),
    (1024, 384, 384, 16, 128, 128),
]


@pytest.mark.parametrize("S,d,n,w,block_n,block_d", SPMM_SWEEP)
def test_spmm_matches_jax_ref_and_pallas(S, d, n, w, block_n, block_d):
    rng = np.random.default_rng(S + w)
    src = rng.standard_normal((S, d)).astype(np.float32)
    idx = rng.integers(0, S, (n, w)).astype(np.int32)
    mask = rng.random((n, w)) < 0.6
    for mean, fn in ((True, spmm_mean), (False, spmm_sum)):
        got = spmm_ref(_t(src), _t(idx), _t(mask), mean=mean)
        want = j_spmm_ref(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(mask), mean=mean)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        pallas = spmm_pallas(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(mask), mean=mean,
                             block_n=block_n, block_d=block_d, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=1e-5)
        assert torch.equal(fn(_t(src), _t(idx), _t(mask)), got)


@pytest.mark.parametrize("S,d,n,w,block_n,block_d", SPMM_SWEEP)
def test_spmm_backward_matches_jax_grad(S, d, n, w, block_n, block_d):
    rng = np.random.default_rng(S * w)
    src = rng.standard_normal((S, d)).astype(np.float32)
    idx = rng.integers(-1, S, (n, w)).astype(np.int32)
    mask = (rng.random((n, w)) < 0.6) & (idx >= 0)
    g = rng.standard_normal((n, d)).astype(np.float32)
    for mean, fn in ((True, spmm_mean), (False, spmm_sum)):
        want = jax.grad(lambda s: jnp.sum(
            j_spmm_ref(s, jnp.asarray(idx), jnp.asarray(mask), mean=mean) * g))(jnp.asarray(src))
        got = spmm_backward_ref(_t(g), _t(idx), _t(mask), S, mean=mean)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        s = _t(src).requires_grad_()
        (auto,) = torch.autograd.grad(fn(s, _t(idx), _t(mask)), s, _t(g))
        assert torch.equal(auto, got)


def test_spmm_all_masked_rows_zero_and_empty():
    src = torch.ones((128, 16))
    idx = torch.zeros((128, 4), dtype=torch.int32)
    mask = torch.zeros((128, 4), dtype=torch.bool)
    assert float(spmm_mean(src, idx, mask).abs().max()) == 0.0
    assert float(spmm_sum(src, idx, mask).abs().max()) == 0.0
    e = torch.zeros((0, 4), dtype=torch.int32)
    assert spmm_sum(src, e, e.bool()).shape == (0, 16)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("frac", [0.02, 0.4, 1.0])
def test_spmm_ref_cpu_rows_match_every_row(mean, frac):
    """On the CPU the plain version adds only the rows with a masked slot;
    bit for bit (int32 views, so the sign of a zero counts) the same as
    adding every row's ``w`` slots, with -0.0, inf and NaN in source rows
    (NaN compared as NaN)."""
    rng = np.random.default_rng(int(frac * 100) + mean)
    S, d, n, w = 70, 5, 300, 9
    src = rng.standard_normal((S, d)).astype(np.float32)
    src[rng.random((S, d)) < 0.2] = -0.0
    src[rng.random((S, d)) < 0.05] = np.inf
    src[rng.random((S, d)) < 0.05] = np.nan
    idx = rng.integers(-1, S + 2, (n, w)).astype(np.int32)
    mask = rng.random((n, w)) < frac
    mask[::7] = False  # rows with no masked slot
    t = [_t(x) for x in (src, idx, mask)]
    got = spmm_ref(*t, mean=mean)
    safe = t[1].clamp(0, S - 1).long()
    want = torch.zeros((n, d))
    for k in range(w):
        want = want + torch.where(t[2][:, k, None], t[0][safe[:, k]], 0.0)
    if mean:
        want = want / t[2].sum(dim=1, keepdim=True).clamp(min=1).float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num().view(torch.int32), want.nan_to_num().view(torch.int32))


# ---------------------------------------------------------------------------
# seg_softmax (GAT edge softmax) and expand_indptr (layer_to_coo)
# ---------------------------------------------------------------------------
SEG_SWEEP = [  # (n, w, frac): tests/test_kernels.py's range, plus w = 32 and 64
    (256, 1, 0.5), (256, 7, 0.1), (512, 13, 0.5), (256, 24, 0.9), (512, 32, 0.3),
    (256, 64, 0.6), (256, 70, 0.5),
]


def _seg_inputs(n, w, frac, h, seed):
    rng = np.random.default_rng(seed)
    e = (3 * rng.standard_normal((n, w, h) if h else (n, w))).astype(np.float32)
    mask = rng.random((n, w)) < frac
    mask[: n // 16] = False  # all-masked rows
    return e, mask


@pytest.mark.parametrize("h", [0, 4], ids=["nw", "nwh"])
@pytest.mark.parametrize("n,w,frac", SEG_SWEEP)
def test_seg_softmax_matches_jax_ref_and_pallas(n, w, frac, h):
    e, mask = _seg_inputs(n, w, frac, h, seed=n + w)
    got = seg_softmax_ref(_t(e), _t(mask))
    want = j_seg_softmax_ref(jnp.asarray(e), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the Pallas kernel takes (n, w): fold the heads into rows as its wrapper does
    e2 = np.moveaxis(e, 2, 1).reshape(-1, w) if h else e
    m2 = np.repeat(mask, h, axis=0) if h else mask
    pallas = np.asarray(seg_softmax_pallas(jnp.asarray(e2), jnp.asarray(m2), block_n=256,
                                           interpret=True))
    if h:
        pallas = np.moveaxis(pallas.reshape(n, h, w), 1, 2)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-6)
    m = mask[..., None] if h else mask
    out = got.numpy()
    assert (np.broadcast_to(~m, out.shape) & (out != 0)).sum() == 0  # masked slots exactly 0
    np.testing.assert_allclose(out.sum(1)[mask.any(1)], 1.0, atol=1e-5)
    assert torch.equal(seg_softmax(_t(e), _t(mask)), got)


@pytest.mark.parametrize("h", [0, 4], ids=["nw", "nwh"])
@pytest.mark.parametrize("n,w,frac", SEG_SWEEP)
def test_seg_softmax_backward_matches_jax_grad(n, w, frac, h):
    e, mask = _seg_inputs(n, w, frac, h, seed=n * w)
    g = np.random.default_rng(w).standard_normal(e.shape).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(j_seg_softmax_ref(x, jnp.asarray(mask)) * g))(
        jnp.asarray(e))
    alpha = seg_softmax_ref(_t(e), _t(mask))
    got = seg_softmax_backward_ref(alpha, _t(g), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(g).max()))
    m = np.broadcast_to((mask[..., None] if h else mask), e.shape)
    assert (got.numpy()[~m] == 0).all()
    x = _t(e).requires_grad_()
    (auto,) = torch.autograd.grad(seg_softmax(x, _t(mask)), x, _t(g))
    assert torch.equal(auto, got)


def test_warp_sum_order():
    """Lane k adds slots k, k+32, ... in turn; then a butterfly over lanes."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 70, 3)).astype(np.float32))
    lanes = torch.zeros((5, 32, 3))
    for k in range(70):
        lanes[:, k % 32] = x[:, k] if k < 32 else lanes[:, k % 32] + x[:, k]
    off = 16
    while off:
        lanes = torch.stack([lanes[:, i] + lanes[:, i ^ off] for i in range(32)], dim=1)
        off //= 2
    assert torch.equal(warp_sum(x), lanes[:, 0])
    assert torch.equal(warp_sum(x[:, :0]), torch.zeros((5, 3)))


def _indptr(R, max_deg, seed, empty_tail=0):
    deg = np.random.default_rng(seed).integers(0, max_deg + 1, size=R)
    deg[R - empty_tail:] = 0
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)


@pytest.mark.parametrize("R,num_edges,empty_tail", [
    (8, 512, 0), (256, 1024, 0), (1, 512, 0),  # tests/test_kernels.py's sweep
    (64, 512, 16),                             # empty rows at the end of indptr
    (256, 512, 0),                             # num_edges < indptr[-1]: cut short
])
def test_expand_indptr_matches_jax_ref_and_pallas(R, num_edges, empty_tail):
    iptr = _indptr(R, 8, R, empty_tail)
    got = expand_indptr_ref(_t(iptr), num_edges)
    assert got.dtype == torch.int32
    _eq(got, j_expand_ref(jnp.asarray(iptr), num_edges))
    _eq(got, expand_indptr_pallas(jnp.asarray(iptr), num_edges, block_e=512, interpret=True))
    assert torch.equal(expand_indptr(_t(iptr), num_edges), got)


@pytest.mark.parametrize("iptr,num_edges", [
    ([0], 5), ([0, 0, 0], 3), ([0, 3], 0), ([0, 2, 2, 5], 300),
])
def test_expand_indptr_edge_cases(iptr, num_edges):
    iptr = np.asarray(iptr, np.int32)
    got = expand_indptr(_t(iptr), num_edges)
    _eq(got, j_expand_ref(jnp.asarray(iptr), num_edges))
