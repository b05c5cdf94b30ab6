"""Quickstart on the PyTorch port: cooperative vs independent minibatching.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port's twin of ``quickstart.py``, at its configuration: builds a
synthetic power-law graph, then samples one minibatch plan both ways --
through the SAME ``MinibatchEngine`` API, differing only in ``mode`` --
at identical global batch size, and prints the feature-loading work
reduction (the paper's core claim).  Finally trains a GCN for a few
cooperative steps.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse

from repro_torch.core import EngineConfig, MinibatchEngine
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.models.gnn import GNNConfig
from repro_torch.train import TrainConfig, train_gnn


def quickstart(scale: int = 12, num_pes: int = 4, local_batch: int = 128,
               num_layers: int = 3, fanout: int = 5, train_pes: int = 2,
               train_batch: int = 64, train_steps: int = 20, device=None) -> dict:
    """The quickstart at ``quickstart.py``'s constants; returns its counts
    and losses."""
    graph = rmat_graph(scale=scale, edge_factor=8, max_degree=32, seed=0, device=device)
    print(f"graph: |V|={graph.num_vertices} |E|={graph.num_edges}")

    # ONE config; the minibatching mode is the only thing that changes.
    cfg = EngineConfig(
        mode="independent", num_pes=num_pes, local_batch=local_batch,
        num_layers=num_layers, sampler="labor0", fanout=fanout, seed=0,
    )

    # --- independent: P PEs, each with its own batch of size local_batch ---
    eng_i = MinibatchEngine.from_config(graph, cfg, device=device)
    plan_i = eng_i.plan_at(0)  # seed draw + RNG + sampling
    indep_inputs = int(plan_i.num_inputs)  # total rows fetched across all PEs

    # --- cooperative: ONE global batch of size P*local_batch, owner-partitioned ---
    eng_c = MinibatchEngine.from_config(graph, cfg.with_mode("cooperative"), device=device)
    plan_c = eng_c.plan_at(0)
    coop_inputs = num_pes * plan_c.stats()["inputs"]  # upper bound: max-per-PE * P

    print(f"independent total feature rows fetched : {indep_inputs}")
    print(f"cooperative total feature rows fetched : <= {coop_inputs} "
          f"({indep_inputs / coop_inputs:.2f}x saving)")

    # --- train a few cooperative steps (same engine under the hood) ---
    ds = SyntheticGraphDataset(graph, feature_dim=32, num_classes=8, seed=0)
    gnn = GNNConfig(model="gcn", num_layers=2, in_dim=32, hidden_dim=64,
                    num_classes=8)
    tc = TrainConfig(mode="cooperative", num_pes=train_pes, local_batch=train_batch,
                     num_steps=train_steps, fanout=fanout, eval_every=0)
    result = train_gnn(ds, gnn, tc, device=device)
    print(f"cooperative training loss: {result.losses[0]:.3f} -> "
          f"{result.losses[-1]:.3f}")
    return dict(num_vertices=graph.num_vertices, num_edges=graph.num_edges,
                indep_inputs=indep_inputs, coop_inputs=coop_inputs,
                losses=result.losses)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    quickstart(device=ap.parse_args().device)
