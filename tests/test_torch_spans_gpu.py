"""Spans and counters inside the captured train step, on a card (marker ``gpu``).

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_spans_gpu.py

* The marker kernel stamps the device's timer: a begin and an end around
  a sleeping kernel give one span of at least its time; a wrong index is
  refused.
* A profiled replay of the captured cooperative GCN step holds every
  expected marker kernel, in stage order, and nothing else named so.
* The program's ``input_rows`` counter after N runs equals the sum of
  ``engine.plan_program``'s counts for those steps, and its spans count
  every run.
* Spans on and spans off train the same bits.
"""
import json

import pytest
import torch

from repro_torch.core.graph import INVALID
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import EngineConfig, MinibatchEngine
from repro_torch.kernels import KernelContractError
from repro_torch.kernels.span_marker import span_marker_cuda
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.train import adam_init, step_program
from repro_torch.utils import spans as sp

pytestmark = pytest.mark.gpu

L, B = 2, 16
CFG = GNNConfig(model="gcn", num_layers=L, in_dim=16, hidden_dim=32, num_classes=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _step(cuda, spans=True, mode="cooperative"):
    ds = SyntheticGraphDataset(rmat_graph(scale=11, edge_factor=8, max_degree=16,
                                          device="cpu"), feature_dim=16, num_classes=4)
    ecfg = EngineConfig(mode=mode, num_pes=4, local_batch=B, num_layers=L, fanout=5,
                        schedule="smoothed", kappa=4, plan_backend="fused")
    eng = MinibatchEngine.from_config(ds.graph, ecfg, dataset=ds, device=cuda)
    net = init_gnn(CFG, seed=0, device=cuda)
    prog = step_program(eng, CFG, net, adam_init(net), torch.as_tensor(ds.labels, device=cuda),
                        1e-2, spans=spans)
    assert prog.capture
    return eng, net, prog


def test_marker_stamps_the_device_timer(cuda):
    acc = torch.zeros(3 * len(sp.SPANS), dtype=torch.int64, device=cuda)
    i = sp.SPANS.index("adam")
    span_marker_cuda(acc, i, False, len(sp.SPANS))
    torch.cuda._sleep(2_000_000)  # about a millisecond
    span_marker_cuda(acc, i, True, len(sp.SPANS))
    got = acc.cpu()
    assert got[3 * i + 1] == 1 and got[3 * i] >= 100_000
    assert int(got.sum() - got[3 * i: 3 * i + 3].sum()) == 0
    with pytest.raises(KernelContractError):
        span_marker_cuda(acc, len(sp.SPANS), False, len(sp.SPANS))


def test_captured_step_holds_the_markers_in_stage_order(cuda, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    eng, _, prog = _step(cuda)
    prog(B, eng.step_state(0))  # the eager warm-up, then the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        prog(B, eng.step_state(1))
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    got = [ev["name"] for ev in sorted(
        (ev for ev in events if ev.get("cat") == "kernel" and ev.get("ph") == "X"),
        key=lambda ev: float(ev["ts"])) if ev["name"].startswith("span_")]
    pair = lambda *names: [n for name in names for n in (f"span_{name}",) * 2]  # noqa: E731
    want = (["span_plan"] + pair(*(f"exchange_ids_l{l}" for l in range(L))) + ["span_plan"]
            + pair("gather")
            + ["span_forward"] + pair(*(f"exchange_fwd_l{l}" for l in reversed(range(L))))
            + ["span_forward"]
            # the deepest layer's input is the features: no gradient exchange there
            + ["span_backward"] + pair(*(f"exchange_bwd_l{l}" for l in range(L - 1)))
            + ["span_backward"] + pair("adam"))
    assert got == want
    assert set(prog.report()[B]["spans"]) == {
        "plan", "gather", "forward", "backward", "adam",
        *(f"exchange.{kind}.l{l}" for kind in ("ids", "fwd") for l in range(L)),
        *(f"exchange.bwd.l{l}" for l in range(L - 1))}


def test_input_rows_counter_equals_the_plans_counts(cuda):
    eng, _, prog = _step(cuda)
    steps = 6
    for s in range(steps):
        prog(B, eng.step_state(s))
    rep = prog.report()[B]
    want = sum(int((eng.plan_program(B, eng.step_state(s))[0].input_ids != INVALID).sum())
               for s in range(steps))
    assert rep["counters"]["input_rows"] == want > 0
    assert rep["replays"] == steps  # the eager first call and every replay
    assert all(s["count"] == steps for s in rep["spans"].values())
    plan = rep["spans"]["plan"]
    assert all(rep["spans"][k]["ms"] > 0 for k in ("plan", "forward", "backward"))
    assert 0 < plan["self_ms"] <= plan["ms"]


@pytest.mark.parametrize("mode", ["cooperative", "independent"])
def test_spans_on_and_off_train_the_same_bits(cuda, mode):
    runs = []
    for spans in (True, False):
        eng, net, prog = _step(cuda, spans=spans, mode=mode)
        losses = [prog(B, eng.step_state(s))[0] for s in range(4)]
        runs.append((torch.stack(losses).cpu(), [p.detach().clone() for p in net.parameters()]))
        assert ("spans" in prog.report()[B]) == spans
    (la, wa), (lb, wb) = runs
    assert torch.equal(la, lb)
    for a, b in zip(wa, wb, strict=True):
        assert torch.equal(a, b)
