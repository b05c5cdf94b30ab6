#!/usr/bin/env python3
"""Time the port's compiled programs' paths on one CUDA card, through the
entry points a user calls, so two trees can be compared in one session:

    PYTHONPATH=<tree>/src python3 tools/program_times.py [--out FILE]

Run it once with each tree's ``src`` on the path, in turns (A, B, B, A),
on the same card.  It uses only entry points that have kept their
signatures since the per-bucket serving programs came in, so the tree
that runs it need not be the one it measures.  It prints, and writes to
``--out`` as JSON:

* GNN training (``train_gnn``, ``chip_smoke.py`` phases 3, 4, 6 and 7:
  cooperative, 4 PEs, batch 64, LABOR-0 (NS for GraphSAGE) fanout 10,
  κ = 16, fused; GCN, GAT with 4 heads and GraphSAGE at 64/256/16 on
  ``rmat_graph(scale=18)``, the R-GCN at 768/1,024/153 with 4 relations):
  the wall ms of each warm step (steps 1.., host clock between the
  ``on_step`` calls, each after the loss's read) and the peak allocated
  memory;
* serving (phase 2's deployment: ``make_recsys`` with 2**20 users, the
  2-layer GCN, the device cache on, fused, the measured clock): every
  bucket captured first, then 4,000 Poisson requests at 1,000/s: p50,
  p95, p99 and the mean plan, gather and forward ms a batch; and one
  served batch's host syncs by the analyzer's trace pass;
* LM decode (phase 11b: gemma2-2b at its published widths and depth,
  float32, batch 4, prompt 16): ms a decode step (median of 24, each
  ended by a sync) and tokens/s;
* the shard executor on one NCCL rank (phase 9b: the GCN cell of
  ``train_gnn`` with ``executor="shard"`` and P = 1, a one-rank process
  group in this process, a FileStore in a temporary directory): the wall
  ms of each warm step as above, then ``engine.plan_at`` alone at every
  step (each ended by a sync; the first call captures where it can);
* LM training (phase 12b: gemma2-2b at its published widths and depth,
  float32, remat, ``make_train_step`` at batch 4 x S 2,048): ms a step
  (each to the loss's read; the first, the warm-up, apart), tokens/s and
  ``model_flops`` a second over 67 TFLOP/s.

The card's name and power limit (``nvidia-smi``) come first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np

SEED = 0
GNNS = {
    "gcn": dict(model="gcn", num_layers=3, in_dim=64, hidden_dim=256, num_classes=16),
    "gat": dict(model="gat", num_layers=3, in_dim=64, hidden_dim=256, num_classes=16,
                num_heads=4),
    "rgcn": dict(model="rgcn", num_layers=3, in_dim=768, hidden_dim=1024, num_classes=153,
                 num_relations=4),
    "sage": dict(model="sage", num_layers=3, in_dim=64, hidden_dim=256, num_classes=16),
}
TRAIN_STEPS = 6
STEADY_REQUESTS, STEADY_RPS = 4000, 1000.0
LM_BATCH, LM_PROMPT, LM_NEW = 4, 16, 24
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 4, 2048, 4


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def gnn_dataset(graphs: dict, kw: dict):
    """Phase 3's scale-18 RMAT dataset at ``kw``'s widths (4 relations for
    the R-GCN), made once a relation count."""
    from repro_torch.data import SyntheticGraphDataset, rmat_graph

    rel = kw.get("num_relations", 1)
    if rel not in graphs:
        graphs[rel] = SyntheticGraphDataset(
            rmat_graph(scale=18, edge_factor=8, max_degree=32, num_edge_types=rel,
                       seed=SEED, device="cpu"),
            feature_dim=kw["in_dim"], num_classes=kw["num_classes"], seed=SEED)
    return graphs[rel]


def train_config():
    from repro_torch.train import TrainConfig

    return TrainConfig(mode="cooperative", num_pes=4, local_batch=64, fanout=10,
                       sampler="labor0", schedule="smoothed", kappa=16, partition="hash",
                       executor="sim", plan_backend="fused", eval_every=0,
                       num_steps=TRAIN_STEPS, seed=SEED)


def train_times(graphs: dict) -> dict:
    import torch
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train import train_gnn

    tc = train_config()
    out = {}
    for name, kw in GNNS.items():
        cfg = GNNConfig(**kw)
        run_tc = dataclasses.replace(tc, sampler="ns") if name == "sage" else tc
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = train_gnn(gnn_dataset(graphs, kw), cfg, run_tc, device="cuda",
                        on_step=lambda step, plan: stamps.append(time.perf_counter()))
        warm = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        out[name] = {"warm_step_ms": warm, "losses": res.losses,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"train {name}: warm steps ms {', '.join(f'{x:.3f}' for x in warm)}; peak "
              f"{out[name]['peak_gib']:.2f} GiB", flush=True)
        del res
    return out


def serve_times() -> dict:
    import torch
    from repro_torch.analysis.trace import record_call
    from repro_torch.data import make_recsys
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.serve import GNNServer, ServeConfig, poisson_trace

    ds = make_recsys(num_users=2**20, num_items=2**16, edges_per_user=8, feature_dim=64,
                     max_degree=64, seed=SEED, device="cuda")
    cfg = GNNConfig(model="gcn", num_layers=2, in_dim=64, hidden_dim=256, num_classes=16)
    server = GNNServer(ds.graph, ds.features, cfg, init_gnn(cfg, seed=SEED, device="cuda"),
                       ServeConfig(plan_backend="fused", use_cache=True,
                                   service_model="measured"), device="cuda")
    server.serve_trace(poisson_trace(64, 4000.0, ds.user_ids, seed=SEED))
    for bucket in server.ladder.buckets:  # every bucket's programs before the clock
        server.hot_path(torch.from_numpy(ds.user_ids[:bucket].astype(np.int32)).cuda())
    server.reset()
    rep = server.serve_trace(poisson_trace(STEADY_REQUESTS, STEADY_RPS, ds.user_ids,
                                           seed=SEED + 1))
    col = lambda f: float(np.mean([getattr(b, f) for b in rep.batches]))  # noqa: E731
    batch = server.coalescer.coalesce(
        poisson_trace(500, 4000.0, ds.user_ids, seed=SEED)[:64], 0.0)
    server._execute(batch, 0)
    _, rec = record_call(torch.device("cuda"), server._execute, batch, 0)
    out = {"p50_ms": rep.percentile_ms(50), "p95_ms": rep.percentile_ms(95),
           "p99_ms": rep.percentile_ms(99), "batches": len(rep.batches),
           "plan_ms": col("plan_ms"), "gather_ms": col("gather_ms"),
           "forward_ms": col("forward_ms"), "wall_ms": col("wall_ms"),
           "batch_syncs": rec.syncs, "batch_sync_warnings": rec.sync_warnings}
    print(f"serve at {STEADY_RPS:.0f}/s: p50 {out['p50_ms']:.3f} p95 {out['p95_ms']:.3f} p99 "
          f"{out['p99_ms']:.3f} ms; a batch {out['wall_ms']:.3f} ms = plan "
          f"{out['plan_ms']:.3f} + gather {out['gather_ms']:.3f} + forward "
          f"{out['forward_ms']:.3f}; a served batch {rec.syncs} syncs / {rec.sync_warnings} "
          "sync-debug warnings", flush=True)
    return out


def decode_times() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import init_decode_state, init_lm, prefill_decode

    cfg = get_config("gemma2-2b")
    model = init_lm(cfg, seed=SEED, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)), dtype=torch.int32, device="cuda")
    serve = make_serve_step(cfg)
    step_ms = []
    for _ in range(2):  # the first round is the warm-up
        state = init_decode_state(cfg, LM_BATCH, LM_PROMPT + LM_NEW, device="cuda")
        logits, state = prefill_decode(model, cfg, state, prompts)
        step_ms = []
        for _ in range(LM_NEW):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = serve(model, state, tok)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(step_ms))
    print(f"decode gemma2-2b batch {LM_BATCH}: {ms:.3f} ms a step (median of {LM_NEW}; "
          f"min {min(step_ms):.3f}, max {max(step_ms):.3f}), {LM_BATCH / ms * 1e3:.1f} "
          "tokens/s", flush=True)
    return {"step_ms": step_ms, "median_ms": ms, "tokens_per_s": LM_BATCH / ms * 1e3}


def shard_times(graphs: dict) -> dict:
    import gc
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.engine import MinibatchEngine
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train import train_gnn

    kw = GNNS["gcn"]
    cfg, ds = GNNConfig(**kw), gnn_dataset(graphs, kw)
    tc = dataclasses.replace(train_config(), num_pes=1, executor="shard")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            stamps = []
            torch.cuda.synchronize()
            res = train_gnn(ds, cfg, tc, device="cuda",
                            on_step=lambda step, plan: stamps.append(time.perf_counter()))
            warm = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
            engine = MinibatchEngine.from_config(ds.graph, tc.engine_config(cfg.num_layers),
                                                 dataset=ds, device="cuda")
            plan_ms = []
            for step in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.plan_at(step)
                torch.cuda.synchronize()
                plan_ms.append(1e3 * (time.perf_counter() - t0))
            out = {"warm_step_ms": warm, "losses": res.losses, "plan_ms": plan_ms}
            del res, engine
            gc.collect()  # the programs go before the group
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    print(f"shard gcn, 1 NCCL rank: warm steps ms {', '.join(f'{x:.3f}' for x in warm)}; "
          f"plan_at ms {', '.join(f'{x:.3f}' for x in plan_ms)}", flush=True)
    return out


def lm_train_times() -> dict:
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import active_param_count, init_lm
    from repro_torch.train import adam_init

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma2-2b")
    B, S = LM_TRAIN_B, LM_TRAIN_S
    model = init_lm(cfg, seed=SEED, device="cuda")
    opt = adam_init(model)
    toks = torch.as_tensor(synthetic_token_batch(B, S + 1, cfg.vocab_size, seed=SEED),
                           device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, lr=1e-3)
    step_ms, losses = [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(step_ms[1:]))
    flops = model_flops(cfg, ShapeSpec("train", S, B, "train"), active_param_count(cfg))
    out = {"first_ms": step_ms[0], "step_ms": step_ms[1:], "median_ms": ms,
           "tokens_per_s": B * S / ms * 1e3, "flop_share": flops / (ms / 1e3) / PEAK_FLOPS,
           "losses": losses}
    print(f"lm train gemma2-2b B {B} x S {S}: first call {step_ms[0]:.1f} ms, then "
          f"{', '.join(f'{x:.1f}' for x in step_ms[1:])} ms (median {ms:.1f}); "
          f"{out['tokens_per_s']:.1f} tokens/s; {out['flop_share']:.4f} of "
          f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s", flush=True)
    del model, opt, step
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("program_times: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"card": card(), "torch": torch.__version__}
    print(out["card"], flush=True)
    graphs = {}
    out["train"] = train_times(graphs)
    out["serve"] = serve_times()
    out["decode"] = decode_times()
    out["shard"] = shard_times(graphs)
    del graphs
    out["lm_train"] = lm_train_times()
    out["seconds"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps({k: v for k, v in out.items() if k != "train"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
