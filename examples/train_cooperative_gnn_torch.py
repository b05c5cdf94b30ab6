"""End-to-end training on the PyTorch port: cooperative + dependent GNN training.

    PYTHONPATH=src python examples/train_cooperative_gnn_torch.py [--steps 300] [--device cpu]

The port's twin of ``train_cooperative_gnn.py``, at its configuration
and defaults: the paper's 3-layer GCN (hidden 256) on a 16k-vertex
synthetic power-law graph, trained for a few hundred steps with
cooperative minibatching (P=4 PEs) and dependent batches (smoothed
kappa=16 by default, ``--schedule nested`` for §3.2 nesting),
evaluating micro-F1 on the validation split, with checkpointing.  All
plan construction goes through the unified ``MinibatchEngine`` inside
``train_gnn`` -- switch ``--mode independent`` and nothing else changes.
Runs on the CUDA card unless ``--device cpu``; ``--plan-backend fused``
builds the plans with the hand-written CUDA kernels there.
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.models.gnn import GNNConfig
from repro_torch.train import TrainConfig, evaluate, save_checkpoint, train_gnn

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "coop_gnn_ckpt")


def train_cooperative_gnn(steps: int = 300, mode: str = "cooperative", pes: int = 4,
                          schedule: str = "smoothed", kappa: int = 16,
                          sampler: str = "labor0", plan_backend: str = "reference",
                          out: str = DEFAULT_OUT, scale: int = 14, device=None) -> dict:
    """Train at ``train_cooperative_gnn.py``'s configuration; returns the
    losses, F1 scores and the trained model."""
    graph = rmat_graph(scale=scale, edge_factor=8, max_degree=32, seed=0, device="cpu")
    ds = SyntheticGraphDataset(graph, feature_dim=64, num_classes=16, seed=0)
    cfg = GNNConfig(model="gcn", num_layers=3, in_dim=64, hidden_dim=256,
                    num_classes=16)
    tc = TrainConfig(
        mode=mode, num_pes=pes, local_batch=64,
        num_steps=steps, fanout=10, schedule=schedule,
        kappa=kappa, sampler=sampler,
        plan_backend=plan_backend,
        eval_every=max(steps // 6, 1),
    )
    t0 = time.time()
    result = train_gnn(ds, cfg, tc, device=device)
    dt = time.time() - t0
    test_f1 = evaluate(ds, cfg, result.model, tc, split="test", device=device)
    print(f"steps={steps}  time={dt:.1f}s  "
          f"loss {result.losses[0]:.3f}->{np.mean(result.losses[-10:]):.3f}")
    print(f"val F1 trajectory: {[round(f, 3) for f in result.val_f1]}")
    print(f"test F1: {test_f1:.3f}")
    save_checkpoint(out, result.model, extra={"steps": steps})
    print(f"checkpoint saved to {out}.npz")
    return dict(losses=result.losses, val_f1=result.val_f1, test_f1=test_f1,
                model=result.model, seconds=dt)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--mode", default="cooperative",
                    choices=["cooperative", "independent"])
    ap.add_argument("--pes", type=int, default=4)
    ap.add_argument("--schedule", default="smoothed",
                    choices=["iid", "smoothed", "nested"])
    ap.add_argument("--kappa", type=int, default=16)
    ap.add_argument("--sampler", default="labor0")
    ap.add_argument("--plan-backend", default="reference",
                    choices=["reference", "fused"],
                    help="frontier lowering: plain torch or the CUDA kernels "
                         "(bit-identical plans)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    train_cooperative_gnn(
        steps=args.steps, mode=args.mode, pes=args.pes, schedule=args.schedule,
        kappa=args.kappa, sampler=args.sampler, plan_backend=args.plan_backend,
        out=args.out, device=args.device,
    )


if __name__ == "__main__":
    main()
