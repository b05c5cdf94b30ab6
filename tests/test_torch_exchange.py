"""The single-device executor's valid-rows exchange on the CPU
(``repro_torch.kernels.exchange``, ``SimExecutor.redistribute``).

Under ``SimExecutor`` a layer's request gather, all-to-all and slot
scatter are one index map.  Its plain version is held against the padded
composition it replaced (:func:`padded_chain`: a ``(P, P, cap_bucket,
d)`` gather of every slot, the axis swap, an ``index_put`` of every slot),
the forward bit for bit and the gradient within ``atol=1e-6``, on:

* tables drawn to have padding, over-capacity drops (tilde rows that no
  slot fills, and slots whose owner dropped the id), rows requested by
  every peer, widths that are and are not multiples of 4, and an ``H``
  that needs no gradient;
* the engine's own plans, at its capacities and at squeezed ones.

Also: the tables invert the plan (each valid slot once, both ways); the
backward adds a row's requesters peer by peer, ascending; the Sim path
calls neither the slot gather nor the executor's all-to-all; the
``exchange.valid_bytes`` counter counts the rows the map copies.  The
shard executor's path is held to the padded composition in
``tests/test_torch_shard.py`` (4 gloo ranks).
"""
import dataclasses

import pytest
import torch

from repro_torch.core import cooperative, frontier
from repro_torch.core.cooperative import ShardExecutor, SimExecutor, redistribute
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import EngineConfig, MinibatchEngine
from repro_torch.kernels.exchange import (
    exchange_backward_ref,
    exchange_rows,
    exchange_tables,
)
from repro_torch.utils import spans as sp
from _padded_exchange import CASES, Tables, drawn_tables, padded_chain

torch.set_num_threads(1)  # the suite runs files in parallel workers


def _check(P, layer, cap_tilde, cap_next, d, grad, seed):
    gen = torch.Generator().manual_seed(seed)
    H = torch.randn((P, cap_next, d), generator=gen).requires_grad_(grad)
    want = padded_chain(P, layer, H, cap_tilde)
    got = redistribute(SimExecutor(P), layer, H, cap_tilde)
    assert got.shape == (P, cap_tilde, d)
    assert torch.equal(got.detach().view(torch.int32), want.detach().view(torch.int32))
    assert got.requires_grad == grad
    if grad:
        G = torch.randn((P, cap_tilde, d), generator=gen)
        (g_want,) = torch.autograd.grad((want * G).sum(), H)
        (g_got,) = torch.autograd.grad((got * G).sum(), H)
        torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("d", [6, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_padded_chain_on_drawn_tables(case, d, grad):
    kw = dict(CASES[case])
    P, cap_tilde, cap_next = kw["P"], kw["cap_tilde"], kw["cap_next"]
    t = drawn_tables(seed=len(case) + d, **kw)
    _check(P, t, cap_tilde, cap_next, d, grad, seed=d)


def test_drawn_tables_cover_the_cases():
    t = drawn_tables(**CASES["over_capacity"])
    kept = (t.slot_to_tilde >= 0).sum(dim=(1, 2))
    assert (kept < CASES["over_capacity"]["rows_a_pe"]).all()  # drops over capacity
    assert ((t.slot_to_tilde >= 0) & (t.req_idx.transpose(0, 1) < 0)).any()  # owner drops
    t = drawn_tables(**CASES["shared_rows"])
    r = t.req_idx[0][t.req_idx[0] >= 0]
    assert torch.unique(r, return_counts=True)[1].max() == 4  # every peer asks for one row


@pytest.fixture(scope="module")
def ds():
    return SyntheticGraphDataset(rmat_graph(scale=10, edge_factor=8, max_degree=16,
                                            device="cpu"), feature_dim=16, num_classes=4)


@pytest.mark.parametrize("bucket_safety", [2.5, 0.15])
def test_plain_equals_padded_chain_on_engine_plans(ds, bucket_safety):
    cfg = EngineConfig(mode="cooperative", num_pes=4, local_batch=8, num_layers=2,
                       sampler="labor0", fanout=5)
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(
        cfg.capacity, bucket_safety=bucket_safety))
    eng = MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device="cpu")
    dropped = 0
    for step in range(3):
        plan = eng.plan_at(step)
        for l, layer in enumerate(plan.layers):
            nxt = plan.input_ids if l + 1 == len(plan.layers) else plan.layers[l + 1].seeds
            tilde_valid = (layer.tilde_ids != cooperative.INVALID).sum()
            dropped += int(tilde_valid - (layer.slot_to_tilde >= 0).sum())
            _check(4, layer, eng.caps.tilde_caps[l], nxt.shape[1], 6, True, seed=step + l)
            fwd, _ = exchange_tables(layer.slot_to_tilde, layer.req_idx,
                                     eng.caps.tilde_caps[l], nxt.shape[1], False)
            assert SimExecutor(4).moved_rows(layer) == (fwd >= 0).sum()
    assert (dropped > 0) == (bucket_safety < 1)


@pytest.mark.parametrize("case", list(CASES))
def test_tables_invert_the_plan(case):
    kw = dict(CASES[case])
    P, cap_tilde, cap_next = kw["P"], kw["cap_tilde"], kw["cap_next"]
    t = drawn_tables(seed=3, **kw)
    fwd, bwd = exchange_tables(t.slot_to_tilde, t.req_idx, cap_tilde, cap_next, True)
    assert fwd.dtype == bwd.dtype == torch.int32
    assert fwd.shape == (P, cap_tilde) and bwd.shape == (P, cap_next, P)
    pairs = 0
    for p in range(P):
        for q in range(P):
            for s in range(kw["cap_b"]):
                tt, r = int(t.slot_to_tilde[p, q, s]), int(t.req_idx[q, p, s])
                if tt >= 0 and r >= 0:
                    assert fwd[p, tt] == q * cap_next + r
                    assert bwd[q, r, p] == p * cap_tilde + tt
                    pairs += 1
    assert (fwd >= 0).sum() == (bwd >= 0).sum() == pairs
    fwd_only, none = exchange_tables(t.slot_to_tilde, t.req_idx, cap_tilde, cap_next, False)
    assert none is None and torch.equal(fwd_only, fwd)


def test_backward_adds_peers_in_ascending_order():
    # one row asked for by all three peers: 1e8 + 1 - 1e8 is 0 in float32,
    # 1e8 - 1e8 + 1 is 1; the order p = 0, 1, 2 gives the first
    g = torch.tensor([[[1e8]], [[1.0]], [[-1e8]]])       # (P, cap_tilde=1, d=1)
    src = torch.tensor([[[0, 1, 2]], [[-1, -1, -1]], [[2, -1, 0]]], dtype=torch.int32)
    got = exchange_backward_ref(g, src)
    assert got[0, 0, 0].item() == 0.0                    # (1e8 + 1) - 1e8
    assert got[1, 0, 0].item() == 0.0                    # nobody asked
    assert got[2, 0, 0].item() == 0.0                    # -1e8 + 1e8
    src2 = torch.tensor([[[0, 2, 1]]], dtype=torch.int32)
    assert exchange_backward_ref(g, src2)[0, 0, 0].item() == 1.0  # the order shows


def test_rows_need_no_gradient_without_bwd_src():
    t = drawn_tables(seed=1, **CASES["padding"])
    fwd, bwd = exchange_tables(t.slot_to_tilde, t.req_idx, 96, 120, False)
    H = torch.randn(4, 120, 8)
    out = exchange_rows(H, fwd, bwd)
    assert bwd is None and not out.requires_grad
    with pytest.raises(RuntimeError, match="no bwd_src"):
        H.requires_grad_(True)
        torch.autograd.grad(exchange_rows(H, fwd, None).sum(), H)


def test_sim_path_moves_no_padded_buffer(monkeypatch):
    """No slot gather, no all-to-all and no per-PE loop on the Sim path."""
    def refuse(*a, **k):
        raise AssertionError("the padded chain ran")

    monkeypatch.setattr(frontier, "take_rows", refuse)
    monkeypatch.setattr(SimExecutor, "exchange", refuse)
    monkeypatch.setattr(SimExecutor, "pe", refuse)
    monkeypatch.setattr(cooperative, "_stack", refuse)
    t = drawn_tables(seed=2, **CASES["shared_rows"])
    H = torch.randn(4, 200, 8, requires_grad=True)
    out = redistribute(SimExecutor(4), t, H, 48, 0)
    torch.autograd.grad(out.sum(), H)


@pytest.mark.parametrize("case", list(CASES))
def test_moved_rows_per_executor(case):
    """The simulated executor moves the slots whose two ends are valid (the
    rows its map copies); a shard rank counts the slots of its buckets that
    hold a row (it cannot see its owners' drops)."""
    kw = dict(CASES[case])
    P = kw["P"]
    t = drawn_tables(seed=5, **kw)
    fwd, _ = exchange_tables(t.slot_to_tilde, t.req_idx, kw["cap_tilde"], kw["cap_next"], False)
    assert SimExecutor(P).moved_rows(t) == (fwd >= 0).sum()
    for p in range(P):
        rank = Tables(t.slot_to_tilde[p], t.req_idx[p])
        assert ShardExecutor(P).moved_rows(rank) == (t.slot_to_tilde[p] >= 0).sum()


def test_valid_bytes_count_the_rows_the_map_copies():
    t = drawn_tables(seed=4, **CASES["over_capacity"])
    rec = sp.SpanRecorder("cpu")
    d = 8
    H = torch.randn(4, 30, d, requires_grad=True)
    with rec.active():
        out = redistribute(SimExecutor(4), t, H, 64, 1)
        torch.autograd.grad(out.sum(), H)
    c = rec.totals()["counters"]
    fwd, _ = exchange_tables(t.slot_to_tilde, t.req_idx, 64, 30, False)
    copied = int((fwd >= 0).sum())
    slots_filled = int((t.slot_to_tilde >= 0).sum())
    assert c["exchange.valid_bytes.l1"] == copied * d * 4
    assert copied < slots_filled  # the owner's drops are not copied
    assert c["exchange.slot_bytes.l1"] == t.slot_to_tilde.numel() * d * 4

