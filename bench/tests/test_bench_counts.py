"""The frozen counts against hand counts at tiny sizes."""
import pytest
import torch

from gnnbench import counts
from gnnbench.sampling import INVALID

I = INVALID


def _work():
    """One PE, two layers: layer 0 has 2 rows and 3 kept edges (two sources,
    relation 0 and 1), layer 1 (the input layer) 4 rows and 2 kept edges."""
    l0 = (torch.tensor([10, 11]), torch.tensor([[1, 2, I], [2, I, I]]),
          torch.tensor([[True, True, False], [True, False, False]]),
          torch.tensor([[0, 1, 0], [0, 0, 0]]))
    l1 = (torch.tensor([1, 2, 10, 11]), torch.tensor([[5, I, I], [I, I, I], [5, 6, I], [I, I, I]]),
          torch.tensor([[True, False, False], [False] * 3, [False, True, False], [False] * 3]),
          torch.zeros((4, 3), dtype=torch.long))
    return [{"layers": [l0, l1], "inputs": torch.tensor([1, 2, 5, 6, 10, 11])}]


GCN = {"kind": "gcn", "num_layers": 2, "in_dim": 4, "hidden_dim": 3, "num_classes": 2}
RGCN = dict(GCN, kind="rgcn", num_relations=2)


def test_gcn_step_flops():
    # layer 0 (d 3 -> 2): aggregation (3 edges + 2 rows) * 3 = 15, transform
    # 2*2*3*2 = 24; forward, weight gradient, input gradient: 15+24+24+24+15
    # layer 1 (d 4 -> 3, input layer): (2 + 4) * 4 = 24, 2*4*4*3 = 96: 24+96+96
    assert counts.step_flops(GCN, _work()) == 102 + 216


def test_rgcn_step_flops():
    # three transforms a layer (self and 2 relations), aggregation e * d
    # layer 0: agg 3*3 = 9, mm 3 * 24 = 72: 9+72 (fwd) +72 (wgrad) +72+9 (input)
    # layer 1: agg 2*4 = 8, mm 3 * 96 = 288: 8+288+288
    assert counts.step_flops(RGCN, _work()) == 234 + 584


def test_gather_cost_counts_duplicates_once_read():
    work = _work() + [{"layers": [], "inputs": torch.tensor([2, 7])}]
    n, distinct, d = 8, 7, 4
    assert counts.gather_cost(GCN, work) == (4 * n + 4 * d * distinct + 4 * d * n, n)


def test_spmm_costs_gcn():
    # layer 0: n 2, w 3, nnz 3, sources {1, 2}, d 3, both rows hit:
    #   forward 6 + 12 + 24 + 24, backward 6 + 12 + 24 + 24; layer 1 forward only:
    #   n 4, nnz 2, sources {5, 6}, d 4: 12 + 8 + 32 + 64
    assert counts.spmm_costs(GCN, _work()) == [(66, 9), (66, 9), (116, 8)]


def test_spmm_costs_rgcn_one_call_a_relation():
    got = counts.spmm_costs(RGCN, _work())
    # layer 0 relation 0: nnz 2 (sources {1, 2}, 2 rows hit); relation 1: nnz 1
    # (source {2}, 1 row hit); layer 1: relation 0 has both edges, relation 1 none
    assert got == [(6 + 8 + 24 + 24, 6), (6 + 8 + 24 + 24, 6),
                   (6 + 4 + 12 + 24, 3), (6 + 4 + 12 + 12, 3),
                   (116, 8), (12 + 0 + 0 + 64, 0)]


def test_bound_takes_the_larger_term_per_call():
    b, o = 3.35e12, 67e12
    assert counts.bound_s([(b, 0), (0, o), (b, 2 * o)]) == pytest.approx(1 + 1 + 2)
