"""The device generator: the same seed gives the same inputs, every seed a
well-formed graph and weights in their Glorot bounds."""
import math

import pytest
import torch

from gnnbench import inputs

SEEDS = [0, 7, 2**31 + 5, 3 * 2**40 + 1]


def _graph(seed, etypes=1):
    return inputs.rmat_graph(seed, 9, 8, 16, etypes, (0.57, 0.19, 0.19), "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    a, b = _graph(seed, 4), _graph(seed, 4)
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices), (a.etypes, b.etypes)):
        assert torch.equal(x, y)
    assert torch.equal(inputs.features(seed, 64, 8, "cpu"), inputs.features(seed, 64, 8, "cpu"))
    assert torch.equal(inputs.labels(seed, 64, 5, "cpu"), inputs.labels(seed, 64, 5, "cpu"))
    assert torch.equal(inputs.train_ids(seed, a, 0.1, "cpu"), inputs.train_ids(seed, b, 0.1, "cpu"))
    model = {"kind": "rgcn", "num_layers": 2, "in_dim": 6, "hidden_dim": 5, "num_classes": 3,
             "num_relations": 2}
    wa, wb = inputs.weights(seed, model, "cpu"), inputs.weights(seed, model, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_other_seed_other_inputs():
    assert not torch.equal(_graph(1).indices[:100], _graph(2).indices[:100])
    assert not torch.equal(inputs.features(1, 16, 4, "cpu"), inputs.features(2, 16, 4, "cpu"))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_graph_is_a_capped_deduplicated_csr(seed):
    g = _graph(seed, 4)
    V = g.num_vertices
    deg = g.indptr[1:] - g.indptr[:-1]
    assert g.indptr[0] == 0 and g.indptr[-1] == g.indices.numel() and bool((deg >= 0).all())
    assert int(deg.max()) == g.max_degree <= 16
    dst = torch.repeat_interleave(torch.arange(V), deg.long())
    src = g.indices.long()
    assert bool((src != dst).all()), "self loops"
    key = dst * V + src
    assert bool((key[1:] > key[:-1]).all()), "rows not ascending, or parallel edges"
    assert g.etypes.shape == g.indices.shape and int(g.etypes.min()) >= 0
    assert int(g.etypes.max()) < 4


def test_train_ids_have_in_edges_and_the_asked_share():
    g = _graph(3)
    ids = inputs.train_ids(3, g, 0.05, "cpu").long()
    deg = g.indptr[1:] - g.indptr[:-1]
    assert ids.numel() == round(0.05 * g.num_vertices)
    assert bool((deg[ids] > 0).all()) and bool((ids[1:] > ids[:-1]).all())


def test_weights_glorot_and_zero_biases():
    model = {"kind": "gcn", "num_layers": 3, "in_dim": 16, "hidden_dim": 32, "num_classes": 8}
    w = inputs.weights(5, model, "cpu")
    assert [k for k in w] == [(l, n) for l in range(3) for n in ("w", "b")]
    for (l, name), t in w.items():
        if name == "b":
            assert not t.any()
        else:
            lim = math.sqrt(6.0 / sum(t.shape[-2:]))
            assert float(t.abs().max()) <= lim and float(t.abs().max()) > 0.5 * lim
    assert w[(2, "w")].shape == (16, 32) and w[(0, "w")].shape == (32, 8)
