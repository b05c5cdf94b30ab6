"""The valid-rows exchange's CUDA kernels on a card (marker ``gpu``).

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_exchange_gpu.py

* The tables (``exchange_invert``) equal their plain version, and the
  forward kernel's rows equal the plain version's and the padded
  composition's bit for bit, at small drawn tables of every case and
  width (1, 3, 6, 8, 64, 128, 768, 1024; float and float4 paths) and at
  the papers100M cell's input layer (P = 4, d = 128, 25.9M slots).
* The backward kernel is within ``atol=1e-6`` of the plain version (the
  same adds in the same order: equal bit for bit too) and gives the same
  bits on a second run.
* Captured in a CUDA graph, forward and backward replay to the eager
  results.
* A cooperative train step on the simulated executor launches the three
  kernels; one forward at the input layer allocates no more than its
  output and its table.
* Wrong dtypes and non-contiguous inputs raise.
"""
import pytest
import torch

from repro_torch.core.cooperative import SimExecutor, redistribute
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.kernels import KernelContractError, LAUNCHES, reset_launches
from repro_torch.kernels.exchange import (
    exchange_backward_cuda,
    exchange_backward_ref,
    exchange_forward_cuda,
    exchange_forward_ref,
    exchange_tables,
    exchange_tables_ref,
)
from repro_torch.models.gnn import GNNConfig
from repro_torch.train import TrainConfig, train_gnn
from _padded_exchange import CASES, Tables, drawn_tables, padded_chain

pytestmark = pytest.mark.gpu

# papers100M cell, input layer (CoopCapacityPlan.geometric(256, 3, 10, 2**24, 4));
# about 6.6% of the slots filled, as its runs read
GCN_INPUT = dict(P=4, cap_b=1_617_176, cap_tilde=2_587_464, cap_next=3_881_200,
                 rows_a_pe=424_000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(t: Tables, dev) -> Tables:
    return Tables(t.slot_to_tilde.to(dev), t.req_idx.to(dev))


def _bits(x):
    return x.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("d", [1, 3, 6, 8, 64, 128, 768, 1024])
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_equal_plain(cuda, case, d):
    kw = CASES[case]
    P, ct, cn = kw["P"], kw["cap_tilde"], kw["cap_next"]
    t = drawn_tables(seed=d, **kw)
    want_f, want_b = exchange_tables_ref(t.slot_to_tilde, t.req_idx, ct, cn, True)
    tc = _on(t, cuda)
    fwd, bwd = exchange_tables(tc.slot_to_tilde, tc.req_idx, ct, cn, True)
    assert torch.equal(fwd.cpu(), want_f) and torch.equal(bwd.cpu(), want_b)
    gen = torch.Generator().manual_seed(d)
    H = torch.randn((P, cn, d), generator=gen)
    G = torch.randn((P, ct, d), generator=gen)
    out = exchange_forward_cuda(H.to(cuda), fwd)
    assert torch.equal(_bits(out.cpu()), _bits(exchange_forward_ref(H, want_f)))
    assert torch.equal(_bits(out.cpu()), _bits(padded_chain(P, t, H, ct)))
    g1 = exchange_backward_cuda(G.to(cuda), bwd)
    g2 = exchange_backward_cuda(G.to(cuda), bwd)
    want_g = exchange_backward_ref(G, want_b)
    torch.testing.assert_close(g1.cpu(), want_g, rtol=0, atol=1e-6)
    assert torch.equal(_bits(g1.cpu()), _bits(want_g))
    assert torch.equal(_bits(g1), _bits(g2))


def test_redistribute_on_card_equals_padded_chain(cuda):
    t = _on(drawn_tables(seed=7, **CASES["shared_rows"]), cuda)
    H = torch.randn((4, 200, 64), device=cuda, requires_grad=True)
    G = torch.randn((4, 48, 64), device=cuda)
    got = redistribute(SimExecutor(4), t, H, 48)
    want = padded_chain(4, t, H, 48)
    assert torch.equal(_bits(got), _bits(want))
    (g_got,) = torch.autograd.grad((got * G).sum(), H)
    (g_want,) = torch.autograd.grad((want * G).sum(), H)
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-6)


def test_gcn_input_layer_shape_and_memory(cuda):
    kw = GCN_INPUT
    P, cb, ct, cn, d = kw["P"], kw["cap_b"], kw["cap_tilde"], kw["cap_next"], 128
    t = _on(drawn_tables(seed=11, **kw), cuda)
    H = torch.randn((P, cn, d), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    reset_launches()
    out = redistribute(SimExecutor(P), t, H, ct)   # H needs no gradient: no bwd_src
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(cuda) - base
    out_bytes, table_bytes = P * ct * d * 4, P * ct * 4
    assert grew <= out_bytes + table_bytes + (4 << 20), (grew, out_bytes, table_bytes)
    assert grew < P * P * cb * d * 4 / 2   # the padded buffer alone is 13.2 GB
    assert (LAUNCHES.get("exchange_invert"), LAUNCHES.get("exchange")) == (1, 1)
    assert LAUNCHES.get("exchange_backward", 0) == 0
    fwd, _ = exchange_tables_ref(t.slot_to_tilde, t.req_idx, ct, cn, False)
    filled = int((fwd >= 0).sum())
    assert 0.05 < filled / (P * P * cb) < 0.08
    want = exchange_forward_ref(H, fwd)
    assert torch.equal(_bits(out), _bits(want))


def test_captured_graph_replays_the_eager_results(cuda):
    t = _on(drawn_tables(seed=5, **CASES["over_capacity"]), cuda)
    H = torch.randn((4, 30, 128), device=cuda, requires_grad=True)
    G = torch.randn((4, 64, 128), device=cuda)

    def step():
        out = redistribute(SimExecutor(4), t, H, 64)
        (g,) = torch.autograd.grad((out * G).sum(), H)
        return out.detach(), g

    want_out, want_g = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, g = step()
    with torch.no_grad():
        H.mul_(2.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(want_out * 2.0))
    assert torch.equal(_bits(g), _bits(want_g))  # the gradient does not depend on H


def test_sim_train_step_launches_the_kernels(cuda):
    ds = SyntheticGraphDataset(rmat_graph(scale=10, edge_factor=8, max_degree=16,
                                          device="cpu"), feature_dim=16, num_classes=4)
    cfg = GNNConfig(model="gcn", num_layers=2, in_dim=16, hidden_dim=32, num_classes=4)
    tc = TrainConfig(mode="cooperative", num_pes=4, local_batch=8, num_steps=2, fanout=5,
                     eval_every=0)
    reset_launches()
    res = train_gnn(ds, cfg, tc, device="cuda")
    assert all(torch.isfinite(torch.tensor(res.losses)))
    # one eager run and its capture: each launch twice; L layers forward,
    # L - 1 backward (the input layer's H takes no gradient)
    assert LAUNCHES.get("exchange_invert", 0) >= 2 * 2
    assert LAUNCHES.get("exchange", 0) >= 2 * 2
    assert LAUNCHES.get("exchange_backward", 0) >= 2 * 1


def test_kernels_refuse_bad_inputs(cuda):
    t = _on(drawn_tables(seed=1, **CASES["padding"]), cuda)
    fwd, bwd = exchange_tables(t.slot_to_tilde, t.req_idx, 96, 120, True)
    H = torch.randn((4, 120, 8), device=cuda)
    with pytest.raises(KernelContractError):
        exchange_forward_cuda(H.double(), fwd)
    with pytest.raises(KernelContractError):
        exchange_forward_cuda(H.transpose(0, 1), fwd)
    with pytest.raises(KernelContractError):
        exchange_forward_cuda(H, fwd.long())
    with pytest.raises(KernelContractError):
        exchange_backward_cuda(torch.randn((4, 96, 8), device=cuda), bwd[:, :, :3].contiguous())
    with pytest.raises(KernelContractError):
        exchange_tables(t.slot_to_tilde.long(), t.req_idx, 96, 120, False)
