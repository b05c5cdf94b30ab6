"""Spans and counters inside the port's programs (``repro_torch.utils.spans``)
on the CPU, where a marker stamps the host's clock.

* A recorder's spans nest: parents, counts, times and self times (a span
  less its children); a backward span begins and ends in the backward of
  the region it wraps, under ``backward``.
* The marker kernel list in ``span_marker.cu`` follows ``SPANS`` in order,
  and the plain marker's arithmetic.
* The train step's counters against independent counts of the same steps
  from ``engine.plan_program``: ``input_rows`` against the valid input
  ids, each layer's exchange bytes against its valid and all slots (a row
  of the layer's width a slot), ``replays`` against the steps.
* ``spans=False`` and ``spans=True`` give the same losses and weights bit
  for bit; a program without spans records none.
* ``train_gnn(stage_times=True)`` in the simulated cooperative mode:
  ``STAGES`` and the exchanges a step (L id, L embedding, L - 1 gradient
  all-to-alls).
* ``host_span`` exists only while a profiler runs.
* A layer past ``MAX_LAYERS`` records nothing and raises nothing: a
  deeper cooperative model trains with spans on, the same bits as off.

Small size: ``rmat_graph(scale=9)``, 2 PEs, local batch 8, 3 layers.
"""
import re
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.graph import INVALID
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import MinibatchEngine
from repro_torch.kernels.span_marker import span_marker_ref
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.train import TrainConfig, adam_init, step_program, train_gnn
from repro_torch.train.loop import STAGES
from repro_torch.utils import spans as sp

torch.set_num_threads(1)  # the suite runs files in parallel workers

L = 3
GCN = dict(model="gcn", num_layers=L, in_dim=8, hidden_dim=16, num_classes=4)
TC = dict(num_pes=2, local_batch=8, fanout=3, schedule="smoothed", kappa=4, eval_every=0,
          plan_backend="fused", lr=1e-2)


@pytest.fixture(scope="module")
def ds():
    return SyntheticGraphDataset(rmat_graph(scale=9, edge_factor=8, max_degree=16,
                                            device="cpu"), feature_dim=8, num_classes=4)


def _program(ds, mode="cooperative", spans=True):
    tc = TrainConfig(mode=mode, num_steps=0, **TC)
    eng = MinibatchEngine.from_config(ds.graph, tc.engine_config(L), dataset=ds, device="cpu")
    model = init_gnn(GNNConfig(**GCN), seed=0, device="cpu")
    prog = step_program(eng, GNNConfig(**GCN), model, adam_init(model),
                        torch.as_tensor(ds.labels), tc.lr, spans=spans)
    return eng, model, prog


def test_spans_nest_with_parents_and_self_time():
    rec = sp.SpanRecorder("cpu")
    with rec.active():
        for _ in range(2):
            with sp.span("forward"):
                time.sleep(0.004)
                with sp.span("exchange.fwd.l0"):
                    time.sleep(0.006)
        with sp.span("adam"):
            pass
        sp.count("input_rows", torch.tensor(5))
        sp.count("input_rows", 2)
        sp.count("input_rows", lambda: torch.tensor(3))
    sp.count("input_rows", 100)  # no recorder active: nothing, and nothing computed
    sp.count("input_rows", lambda: pytest.fail("computed without a recorder"))
    with sp.span("adam"):
        pass
    got = rec.totals()
    s = got["spans"]
    assert list(s) == ["forward", "exchange.fwd.l0", "adam"]
    assert (s["forward"]["parent"], s["exchange.fwd.l0"]["parent"], s["adam"]["parent"]) == \
        (None, "forward", None)
    assert [s[k]["count"] for k in s] == [2, 2, 1]
    assert s["exchange.fwd.l0"]["ms"] >= 12.0 and s["forward"]["ms"] >= 20.0
    assert s["forward"]["self_ms"] == pytest.approx(s["forward"]["ms"]
                                                    - s["exchange.fwd.l0"]["ms"])
    assert s["forward"]["self_ms"] >= 8.0
    assert s["exchange.fwd.l0"]["self_ms"] == s["exchange.fwd.l0"]["ms"]
    assert got["counters"] == {"input_rows": 10} and got["replays"] == 0
    with pytest.raises(ValueError, match="no span"), rec.active(), sp.span("nope"):
        pass
    with pytest.raises(ValueError, match="no counter"):
        rec.count("nope", 1)
    rec.mark("plan", False)
    with pytest.raises(RuntimeError, match="ends while"):
        rec.mark("gather", True)


def test_backward_span_wraps_the_backward_of_its_region():
    rec = sp.SpanRecorder("cpu")
    w = torch.randn(4, 4, requires_grad=True)
    with rec.active():
        with sp.span("forward"):
            x = sp.mark_backward(w * 2, "exchange.bwd.l1", end=True)
            y = sp.mark_backward((x @ x).tanh(), "exchange.bwd.l1", end=False)
            loss = y.sum()
        with sp.span("backward"):
            (g,) = torch.autograd.grad(loss, [w])
    s = rec.totals()["spans"]
    assert s["exchange.bwd.l1"] == {"count": 1, "ms": s["exchange.bwd.l1"]["ms"],
                                    "parent": "backward",
                                    "self_ms": s["exchange.bwd.l1"]["ms"]}
    assert 0 < s["exchange.bwd.l1"]["ms"] <= s["backward"]["ms"]
    x = w * 2
    np.testing.assert_array_equal(g.numpy(), torch.autograd.grad(((x @ x).tanh()).sum(),
                                                                 [w])[0].numpy())
    # no recorder, or no gradient: the tensor itself
    v = torch.ones(2)
    assert sp.mark_backward(v, "exchange.bwd.l0", True) is v
    with rec.active():
        assert sp.mark_backward(v, "exchange.bwd.l0", True) is v


def test_marker_kernels_follow_spans_and_the_plain_marker_stamps_the_clock():
    src = Path(sp.__file__).resolve().parents[1] / "kernels" / "span_marker" / "span_marker.cu"
    text = src.read_text()
    layers = re.search(r"#define SPAN_LAYERS\(X, kind\)(.*?)\n\n", text, re.S).group(1)
    per_layer = re.findall(r"X\(exchange_##kind##_l(\d)\)", layers)
    kernels = re.search(r"#define SPAN_KERNELS\(X\)(.*?)\n\n", text, re.S).group(1)
    names = []
    for tok in re.findall(r"SPAN_LAYERS\(X, (\w+)\)|X\((\w+)\)", kernels):
        names += [f"exchange.{tok[0]}.l{l}" for l in per_layer] if tok[0] else [tok[1]]
    assert tuple(names) == sp.SPANS
    assert len(per_layer) == sp.MAX_LAYERS
    acc = torch.zeros(9, dtype=torch.int64)
    span_marker_ref(acc, 1, False)
    start = int(acc[5])
    assert start > 0 and acc[3] == acc[4] == 0
    span_marker_ref(acc, 1, True)
    assert acc[4] == 1 and 0 <= int(acc[3]) <= time.perf_counter_ns() - start
    assert not acc[:3].any() and not acc[6:].any()


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
def test_step_counters_equal_the_plans_counts(ds, mode):
    eng, _, prog = _program(ds, mode)
    b, steps = TC["local_batch"], 3
    for s in range(steps):
        prog(b, eng.step_state(s))
    got = prog.spans()[b]
    assert got["replays"] == steps
    c = got["counters"]
    rows, valid, slots, ids = 0, [0] * L, [0] * L, [0] * L
    for s in range(steps):
        plan, _ = eng.plan_program(b, eng.step_state(s))
        rows += int((plan.input_ids != INVALID).sum())
        for l, layer in enumerate(plan.layers if mode == "cooperative" else ()):
            d = GCN["in_dim"] if l == L - 1 else GCN["hidden_dim"]
            valid[l] += int((layer.slot_to_tilde >= 0).sum()) * d * 4
            slots[l] += layer.slot_to_tilde.numel() * d * 4
            ids[l] += layer.slot_to_tilde.numel() * 4
    assert c["input_rows"] == rows > 0
    if mode == "independent":
        assert set(c) == {"replays", "input_rows"}
        assert not any(k.startswith("exchange") for k in got["spans"])
        return
    for l in range(L):
        assert c[f"exchange.valid_bytes.l{l}"] == valid[l] > 0
        assert c[f"exchange.slot_bytes.l{l}"] == slots[l] > valid[l]
        assert c[f"exchange.id_bytes.l{l}"] == ids[l]
    spans = got["spans"]
    assert spans["plan"]["parent"] is None
    for l in range(L):
        assert spans[f"exchange.ids.l{l}"]["parent"] == "plan"
        assert spans[f"exchange.fwd.l{l}"]["parent"] == "forward"
        assert spans[f"exchange.fwd.l{l}"]["count"] == steps
    # the deepest layer's input is the features: no gradient to exchange
    assert [spans.get(f"exchange.bwd.l{l}", {}).get("count") for l in range(L)] == \
        [steps] * (L - 1) + [None]
    assert spans["exchange.bwd.l0"]["parent"] == "backward"
    assert {"gather", "forward", "backward", "adam"} <= set(spans)
    assert prog.spans()[b]["replays"] == 0  # a drain returns what changed since the last


def test_spans_on_and_off_train_the_same_bits(ds):
    runs = []
    for spans in (True, False):
        eng, model, prog = _program(ds, spans=spans)
        losses = [float(prog(TC["local_batch"], eng.step_state(s))[0]) for s in range(3)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()], prog))
    (la, wa, on), (lb, wb, off) = runs
    assert la == lb
    for a, b in zip(wa, wb, strict=True):
        assert torch.equal(a, b)
    assert on.spans()[TC["local_batch"]]["replays"] == 3
    assert off.spans() == {} and off.report() == {}


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
def test_train_gnn_stage_times_from_spans(ds, mode):
    res = train_gnn(ds, GNNConfig(**GCN), TrainConfig(mode=mode, num_steps=2, **TC),
                    device="cpu", stage_times=True)
    assert [set(s) for s in res.stage_ms] == [set(STAGES)] * 2
    assert all(v > 0 for s in res.stage_ms for v in s.values())
    if mode == "independent":
        assert res.exchanges == []
        return
    for e in res.exchanges:
        assert [e[k][0] for k in ("ids", "forward", "backward")] == [L, L, L - 1]
        assert e["forward"][1] > e["backward"][1] > e["ids"][1] > 0
        assert all(e[k][2] > 0 for k in e)


def test_host_span_only_under_a_profiler(ds):
    from torch.profiler import ProfilerActivity, profile

    eng, _, _ = _program(ds, mode="independent")
    assert isinstance(sp.host_span("x"), nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step_state(1)
    assert "engine.step_state" in {e.key for e in prof.key_averages()}


def test_layers_past_the_list_record_nothing(ds):
    rec = sp.SpanRecorder("cpu")
    deep = sp.MAX_LAYERS
    with rec.active():
        with sp.span(f"exchange.fwd.l{deep}"):
            sp.count(f"exchange.slot_bytes.l{deep}",
                     lambda: pytest.fail("computed for a layer past the list"))
        v = torch.ones(2, requires_grad=True)
        assert sp.mark_backward(v, f"exchange.bwd.l{deep}", True) is v
        with pytest.raises(ValueError, match="no span"), sp.span("exchange.fwd"):
            pass
    assert rec.totals() == {"spans": {}, "counters": {}, "replays": 0}

    depth = sp.MAX_LAYERS + 1
    cfg = GNNConfig(**{**GCN, "num_layers": depth})
    tc = TrainConfig(mode="cooperative", num_steps=0, **{**TC, "fanout": 2})
    runs = []
    for spans in (True, False):
        eng = MinibatchEngine.from_config(ds.graph, tc.engine_config(depth), dataset=ds,
                                          device="cpu")
        model = init_gnn(cfg, seed=0, device="cpu")
        prog = step_program(eng, cfg, model, adam_init(model), torch.as_tensor(ds.labels),
                            tc.lr, spans=spans)
        loss = float(prog(tc.local_batch, eng.step_state(0))[0])
        runs.append((loss, [p.detach().clone() for p in model.parameters()], prog))
    (la, wa, on), (lb, wb, _) = runs
    assert la == lb and all(torch.equal(a, b) for a, b in zip(wa, wb, strict=True))
    got = on.spans()[tc.local_batch]
    layers = {int(k.rsplit(".l", 1)[1]) for k in [*got["spans"], *got["counters"]]
              if k.startswith("exchange.")}
    assert layers == set(range(sp.MAX_LAYERS))
