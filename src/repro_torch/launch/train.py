"""Training launcher of the port (the GNN half of ``repro.launch.train``).

One process, the stacked-PE simulation (``--device cpu`` on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train gnn \\
        --mode cooperative --pes 4 --steps 100 --kappa 16

One process per PE (``--executor shard``), NCCL on a host with 4 cards,
gloo with ``--device cpu``::

    PYTHONPATH=src torchrun --standalone --nproc-per-node=4 \\
        -m repro_torch.launch.train gnn --executor shard --pes 4 --steps 100

Rank 0 prints each step's global loss and the micro-F1s.  Under NCCL
each rank's step is one captured CUDA graph (its all-to-alls and
all-reduces in it; the plan built by the kernels); under gloo it runs
eagerly.  On a card the simulated step and the LM step are one captured
graph each too.

LM pool (the published config, or ``--reduced`` for the 2-layer smoke
size; synthetic Zipf tokens, ``init_lm(seed=0)``)::

    PYTHONPATH=src python -m repro_torch.launch.train lm --arch granite-3-8b \
        --steps 3 --reduced --device cpu
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
        # the kernels' plan build on a card: the one a captured step can hold
        # (the reference backend's dedup has a data-dependent shape)
        tc = TrainConfig(mode=args.mode, num_pes=args.pes, local_batch=args.batch,
                         num_steps=args.steps, fanout=args.fanout, kappa=args.kappa,
                         sampler=args.sampler, partition=args.partition,
                         eval_every=max(args.steps // 5, 1), executor=args.executor,
                         plan_backend="reference" if args.device == "cpu" else "fused")
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
    """``args.steps`` train steps on one fixed synthetic batch, as the JAX
    launcher runs them; prints each step's loss."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.optim import adam_init

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = init_lm(cfg, seed=0, device=dev)
    opt = adam_init(model)
    step = make_train_step(cfg, lr=1e-3)
    B, S = args.batch, args.seq
    s_text = S - cfg.num_prefix_tokens
    toks = torch.as_tensor(synthetic_token_batch(B, s_text + 1, cfg.vocab_size, seed=0),
                           device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.num_prefix_tokens:
        batch["prefix_embeds"] = torch.zeros((B, cfg.num_prefix_tokens, cfg.d_model),
                                             dtype=cfg.torch_dtype, device=dev)
    if cfg.enc_dec:
        batch["enc_out"] = torch.zeros((B, cfg.enc_len, cfg.d_model), dtype=cfg.torch_dtype,
                                       device=dev)
    t0 = time.time()
    for i in range(args.steps):
        model, opt, metrics = step(model, opt, batch)
        print(f"step {i}: loss={float(metrics['loss']):.4f}", flush=True)
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")


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
    l.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")

    args = ap.parse_args(argv)
    if args.cmd == "gnn":
        run_gnn(args)
    else:
        run_lm(args)


if __name__ == "__main__":
    main()
