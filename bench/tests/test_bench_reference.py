"""The plain reference against the port on the CPU at a tiny size."""
import dataclasses

import numpy as np
import pytest
import torch

from gnnbench import harness, inputs, loader, plancheck
from gnnbench.sampling import INVALID
from gnnbench.reference import Reference

CELLS = ["gcn-papers100m.coop", "gcn-papers100m.indep", "rgcn-mag240m.coop"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_passes_the_check(run_tiny, cell):
    out, lines = run_tiny(cell, seed=2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["checks"]["plan_mismatch"]["value"] == 0
    assert any(line.startswith("detail loss step 0") for line in lines)


def _engine_and_ref(tiny, cell, seed):
    from repro_torch.core.graph import Graph
    from repro_torch.engine import MinibatchEngine
    from repro_torch.train.loop import TrainConfig

    root, bench = tiny
    c = loader.cell(cell, bench)
    cfg = loader.config(c["config"], bench)
    g, sc = cfg["graph"], cfg["sampler"]
    ga = inputs.graph_of(seed, cfg, "cpu")
    labels = inputs.labels(seed, ga.num_vertices, 4, "cpu")
    train = inputs.train_ids(seed, ga, g["train_fraction"], "cpu")
    graph = Graph(ga.indptr, ga.indices, ga.etypes, ga.max_degree, ga.num_vertices,
                  int(ga.indices.numel()), ga.num_edge_types)

    class DS:
        features = np.zeros((ga.num_vertices, 2), np.float32)
        train_ids = train.numpy()

    tc = TrainConfig(mode=c["mode"], num_pes=harness.NUM_PES, local_batch=c["local_batch"],
                     sampler=sc["name"], fanout=sc["fanout"], schedule=sc["schedule"],
                     kappa=sc["kappa"], partition=sc["partition"], seed=seed,
                     plan_backend=sc["plan_backend"])
    engine = MinibatchEngine.from_config(graph, tc.engine_config(cfg["model"]["num_layers"]),
                                         dataset=DS(), device="cpu")
    ref = Reference(ga, labels, train, cfg, c["mode"], harness.NUM_PES, c["local_batch"], seed)
    return engine, ref, ga


@pytest.mark.parametrize("cell", CELLS)
def test_seed_draw_and_frontiers_equal_the_ports(tiny, cell):
    from repro_torch.core.graph import INVALID

    engine, ref, ga = _engine_and_ref(tiny, cell, 5)
    for step in range(3):
        assert np.array_equal(ref.seeds(step).numpy(), engine.seed_batch(step))
        plan = engine.plan_at(step)
        got = plan.input_ids.reshape(-1).long()
        got = torch.sort(got[got != INVALID]).values
        want = torch.sort(torch.cat([pe["inputs"] for pe in ref.pe_work(step)])).values
        assert torch.equal(got, want)
        bad = plancheck.mismatch(plan, ref.pe_work(step), ref.owner, ga.num_vertices,
                                 ga.num_edge_types, cell.endswith(".coop"))
        assert not any(bad.values()), bad


def _input_on_wrong_pe(plan):
    ids = plan.input_ids.clone()
    j = int((ids[0] != INVALID).nonzero()[0])
    k = int((ids[1] == INVALID).nonzero()[0])
    ids[1, k], ids[0, j] = ids[0, j], INVALID
    return dataclasses.replace(plan, input_ids=ids), ("inputs", "exchange")


def _slot_to_wrong_peer(plan):
    lay = plan.layers[1]
    s2t = lay.slot_to_tilde.clone()
    a = int((s2t[0, 0] >= 0).nonzero()[0])
    b = int((s2t[0, 1] >= 0).nonzero()[0])
    s2t[0, 0, a], s2t[0, 1, b] = s2t[0, 1, b].clone(), s2t[0, 0, a].clone()
    layers = list(plan.layers)
    layers[1] = dataclasses.replace(lay, slot_to_tilde=s2t)
    return dataclasses.replace(plan, layers=tuple(layers)), ("exchange",)


def _edge_to_another_source(plan):
    lay = plan.layers[0]
    nbr = lay.nbr_idx.clone()
    i, k = (int(x) for x in lay.mask[0].nonzero()[0])
    nbr[0, i, k] = lay.self_idx[0, i]
    layers = list(plan.layers)
    layers[0] = dataclasses.replace(lay, nbr_idx=nbr)
    return dataclasses.replace(plan, layers=tuple(layers)), ("edges",)


@pytest.mark.parametrize("corrupt", [_input_on_wrong_pe, _slot_to_wrong_peer,
                                     _edge_to_another_source])
def test_the_plan_check_sees_a_wrong_plan(tiny, corrupt):
    """An id held by the wrong PE, a bucket slot sent to the wrong peer and an
    edge from the wrong source each count, though the multisets of all PEs'
    seed and input ids stay the same."""
    engine, ref, ga = _engine_and_ref(tiny, "gcn-papers100m.coop", 5)
    plan, parts = corrupt(engine.plan_at(0))
    bad = plancheck.mismatch(plan, ref.pe_work(0), ref.owner, ga.num_vertices,
                             ga.num_edge_types, True)
    assert all(bad[p] > 0 for p in parts), bad
