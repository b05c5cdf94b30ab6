"""Training launcher of the port (the GNN half of ``repro.launch.train``).

One process, the stacked-PE simulation (``--device cpu`` on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train gnn \\
        --mode cooperative --pes 4 --steps 100 --kappa 16

One process per PE (``--executor shard``), NCCL on a host with 4 cards,
gloo with ``--device cpu``::

    PYTHONPATH=src torchrun --standalone --nproc-per-node=4 \\
        -m repro_torch.launch.train gnn --executor shard --pes 4 --steps 100

Rank 0 prints each step's global loss and the micro-F1s.  The ``lm``
subcommand (LM training) is not ported yet: the LM pool only serves.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np

# how long a collective waits for the other ranks before it fails the run
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=5)


def run_gnn(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.data import SyntheticGraphDataset, rmat_graph
    from repro_torch.launch.mesh import rank_device
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train import TrainConfig, evaluate, train_gnn

    shard = args.executor == "shard"
    if shard and "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"--executor shard runs one process per PE: start it with "
                         f"torchrun --nproc-per-node={args.pes} -m repro_torch.launch.train ...")
    if shard:
        backend = "gloo" if args.device == "cpu" else "nccl"
        dist.init_process_group(backend, timeout=COLLECTIVE_TIMEOUT)
        if backend == "nccl":
            torch.cuda.set_device(rank_device())
    try:
        graph = rmat_graph(scale=args.scale, edge_factor=8, max_degree=32, seed=0, device="cpu")
        ds = SyntheticGraphDataset(graph, feature_dim=64, num_classes=16, seed=0)
        cfg = GNNConfig(model=args.model, num_layers=args.layers, in_dim=64,
                        hidden_dim=args.hidden, num_classes=16,
                        num_relations=graph.num_edge_types)
        tc = TrainConfig(mode=args.mode, num_pes=args.pes, local_batch=args.batch,
                         num_steps=args.steps, fanout=args.fanout, kappa=args.kappa,
                         sampler=args.sampler, partition=args.partition,
                         eval_every=max(args.steps // 5, 1), executor=args.executor)
        t0 = time.time()
        r = train_gnn(ds, cfg, tc, device=args.device)
        test_f1 = evaluate(ds, cfg, r.model, tc, split="test", device=args.device)
        if not shard or dist.get_rank() == 0:
            for i, loss in enumerate(r.losses):
                print(f"step {i}: loss {loss!r}")
            print(f"[{args.mode}, {args.executor}] {args.steps} steps in "
                  f"{time.time() - t0:.1f}s  loss {r.losses[0]:.3f}->"
                  f"{np.mean(r.losses[-5:]):.3f}  val_f1={r.val_f1}")
            print(f"test_f1={test_f1:.3f}")
    finally:
        if shard:
            dist.destroy_process_group()


def run_lm(args) -> None:
    raise NotImplementedError(
        "LM training (lm_loss, make_train_step) is not ported to repro_torch yet; "
        "the LM pool serves (repro_torch.launch.steps.make_serve_step) "
        "(ROADMAP.md queue A, item A14)"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gnn")
    g.add_argument("--mode", default="cooperative",
                   choices=["cooperative", "independent"])
    g.add_argument("--model", default="gcn",
                   choices=["gcn", "sage", "gat", "rgcn"])
    g.add_argument("--pes", type=int, default=4)
    g.add_argument("--batch", type=int, default=64)
    g.add_argument("--steps", type=int, default=50)
    g.add_argument("--layers", type=int, default=3)
    g.add_argument("--hidden", type=int, default=128)
    g.add_argument("--fanout", type=int, default=10)
    g.add_argument("--kappa", type=int, default=1)
    g.add_argument("--sampler", default="labor0")
    g.add_argument("--partition", default="hash")
    g.add_argument("--scale", type=int, default=12)
    g.add_argument("--executor", default="sim", choices=["sim", "shard"])
    g.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")

    l = sub.add_parser("lm")
    l.add_argument("--arch", required=True)
    l.add_argument("--reduced", action="store_true")
    l.add_argument("--steps", type=int, default=3)
    l.add_argument("--batch", type=int, default=2)
    l.add_argument("--seq", type=int, default=64)

    args = ap.parse_args(argv)
    if args.cmd == "gnn":
        run_gnn(args)
    else:
        run_lm(args)


if __name__ == "__main__":
    main()
