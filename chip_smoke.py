#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, dependent-minibatching and
multi-process cooperative paths, its examples, its analyzer, the LM
pool's serving and training and the dry-run once on one NVIDIA GPU.

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --kernels-only   # phases 0-1 only (a kernel edit's check)

Phases:

0. Device and build: the card's name and power limit, torch and CUDA
   versions, TF32 off, and the build of every CUDA kernel of the port
   (``nvcc`` for ``sm_90a``, one process per source, in parallel).
1. Kernels against their plain torch versions, on the card, on inputs
   from a numpy seed: the serving kernels at the serving path's shapes,
   ``frontier_gather`` at PE 0's frontier of every layer of a training
   step, ``unique_compact`` at all 7 dedups of a training step, ``gather``,
   ``spmm`` (forward and backward, every layer), ``seg_softmax`` (forward
   and backward, 4 heads) and ``expand_indptr`` at the training path's
   shapes, with the index tables and masks of a real training plan.  Every
   kernel must be equal bit for bit to its plain version (``frontier_gather``
   in both its outputs, the table and the mask, from one CUDA kernel a
   call; ``tag_probe`` from one; the ``spmm``
   backward also to itself over two calls), except ``seg_softmax``:
   forward within ``atol=1e-6``, backward within ``atol=1e-6 * max|g|``,
   masked slots exactly 0.  Each row names the paths that run its shape
   (the ``spmm`` backward at the last plan layer runs on none: that layer
   reads the raw features) and its launches per batch or step.  Each
   kernel's device time (CUDA-graph replay, after warm-up replays of at
   least 10 calls and 20 ms) and event time, its plain
   version's, a library yardstick where one PyTorch call computes the same
   function (timed like the kernel, by graph replay, unless the call syncs
   the device, as ``torch.unique`` does: then by its profiled kernel sum,
   beside the kernel's own; the method is printed with each time), and
   its bound: the larger of its bytes over the memory rate and its
   operations over the scalar rate.  ``spmm``'s mean mode (forward and
   backward) gets rows of its own at the R-GCN path's shapes (phase 6's
   step-0 plan, PE 0, relation 0's slots, d = 1,024, 1,024, 768; the
   backward at plan layers 0 and 1) and at GraphSAGE's plan layer 2 (phase
   7, d = 64).  ``frontier_gather``, ``unique_compact`` and ``gather`` get
   rows at the shapes of phases 6 and 7 as at the GCN's: step 0's plan of
   the R-GCN (its ``gather`` at d = 768) and of GraphSAGE with NS, one
   ``plan_at(0)`` each with ``rw`` and ``full``, and the work curves' NS
   plan at batch 1,024 (a row on the same inputs as an earlier row names
   the new path there).  One more ``gather`` row, off the paths, takes
   262,144 ids drawn from the R-GCN's table, all valid (the valid-row
   branch, which the paths' 98% padding barely runs).  Phase 8's path
   adds rows: its cooperative κ = 16 plans are the R-GCN's (their rows
   only gain the path's name), its independent step-0 plan gets
   ``frontier_gather`` and ``unique_compact`` rows of its own (PE 0), and
   ``tag_probe`` gets a row at each mode's probe of step 1 (the inputs the
   tiered store passes, recorded, n = P x the input cap, S = 32,768 sets,
   W = 8).  Each ``gather`` row
   prints the card's write rate for the same output beside the kernel
   (``fill_ms``: ``torch.zeros((n, d))`` by graph replay) and checks one
   launch a call.  The ``seg_softmax`` and on-path ``gather`` rows print
   the replaced design's time beside the new one ("was"), the
   ``frontier_gather`` rows the replaced design's separate mask op
   (``nbr != INVALID``) by graph replay at the same shape.  The two deepest
   dedups are also timed whole (sort + kernel) beside ``torch.unique``.
2. Serve: a 1.1M-vertex user-item graph (``make_recsys`` with 2**20
   users), the GCN at full width (in 64, hidden 256, 16 classes, two
   layers) with ``init_gnn``'s weights for seed 0 (the JAX package's
   initial weights for that seed), and a 500-request Poisson
   trace at 4000 requests/s through ``repro_torch.serve.GNNServer``
   with ``plan_backend="fused"`` and the device cache on: ``serve.plan``
   and ``serve.forward`` run as one captured CUDA graph per bucket, and
   so do the tiered store's ``store.clock_access`` and ``store.assemble``
   (the host fill of the missed rows between them), each captured once
   (``compiles`` 1 a bucket; capture ms, pool bytes and launches a replay
   printed).  The launch
   counters are zeroed right before and read right after; every kernel
   of the path (the GCN's ``spmm`` forward too) must have launched.  The
   same trace through a ``device="cpu"`` server (the plain path) must give
   identical integer accounting, every batch's plan entries equal bit for
   bit (the replayed ``serve.plan`` against the card's eager build of the
   same seeds and the CPU's, with plan ms a batch replayed against eager),
   and logits within ``atol=1e-4``; ``spmm`` must equal its plain
   version bit for bit on the largest layer of the largest served batch's
   plan; the first 32 requests served one at a time must
   agree with their coalesced logits.  Then, on the measured clock, the
   same trace (which overloads the server) and a 4000-request trace at
   1000 requests/s (which it keeps up with): latencies, wall ms per batch
   and the server's split of it into plan build, feature gather and
   forward; last, a profile of one served trace, with the device ms per
   batch of ``frontier_gather`` and ``tag_probe``.
3. Train: ``repro_torch.train.train_gnn`` with the training example's
   configuration (cooperative, 4 PEs in the stacked ``SimExecutor``
   layout, local batch 64, LABOR-0 fanout 10, smoothed kappa 16, hash
   partition, ``plan_backend="fused"``) and a 3-layer GCN at full width
   (in 64, hidden 256, 16 classes; ``train_gnn``'s own weights, those of
   ``init_gnn`` for seed 0, which are the JAX package's) on
   ``rmat_graph(scale=18, edge_factor=8, max_degree=32)``, 4 steps on
   the card and the same 4 steps on the CPU (the plain path).  On the
   card the whole step (plan, gather, forward, backward, Adam) is one
   captured CUDA graph (``train.step_program``; step 0 is its eager
   warm-up, then the capture), replayed every step and captured once
   (capture ms and pool bytes printed).  The counters are zeroed right
   before the card run; every kernel of the path must have launched.
   Seed batches, every integer leaf of every step's plan and the plan
   stats must equal the CPU run's; losses agree within ``rtol=1e-4`` and
   the final weights within ``atol=1e-4``.  Per step: the captured
   step's wall ms (to the loss's read), each kernel's launches and its
   stage split (``stage_times=True``: the step program's spans read after
   each step, device ms of plan, gather, forward+backward and Adam).  The
   same steps again on the card through the step program's body run
   eagerly (``program.fn``: no graph, no spans): its plans must equal the
   captured run's bit for bit, its losses, final weights and step-0
   gradients agree as the CPU's must (the distance printed).  Then the
   device idle share over two more captured steps under the profiler,
   with the device ms per
   step of the ``frontier_gather`` and ``unique_compact`` kernels, the
   ``spmm`` and ``seg_softmax`` forward and backward kernels, every sort
   and every memset, beside the plan ms per step; each
   ``Graph.neighbor_table`` call there must make one ``frontier_gather``
   launch and one CUDA kernel.  ``plan_at`` is one captured CUDA graph
   replayed every step (the first call runs eagerly, then captures); on a
   fresh engine of the same configuration the replays at steps 0, 1, 15,
   16 and 17 (c = 0 and the κ = 16 window edge) must equal the eager
   build of the same step state and the CPU's plan and seeds bit for bit,
   with one capture; replayed and eager ms are printed beside the
   capture's ms, pool bytes and launches a replay (``phase_compiled``).
4. Train the GAT: phase 3 again with a 3-layer GAT at the same width and
   4 heads (``GNNConfig(model="gat", num_heads=4)``), same graph, plans
   and checks; its attention softmax runs through ``seg_softmax`` and its
   backward kernel.
5. COO: ``repro_torch.core.layer_to_coo(backend="fused")`` on PE 0's
   block of every layer of phase 4's step-0 card plan, counters zeroed
   right before; ``expand_indptr`` must have launched and every output
   must equal the CPU's ``layer_to_coo`` on the same plan.
6. Train the R-GCN at the JAX package's mag240M widths
   (``src/repro/launch/gnn_dryrun.py``'s ``SCALE_MAG``: 768 input
   features, hidden 1,024, 153 classes, 3 layers, 4 relations) with phase
   3's ``TrainConfig`` on phase 3's graph with 4 uniform relation ids
   (``rmat_graph(..., num_edge_types=4)``), float32, TF32 off: its 4
   relation means a layer go through ``spmm``'s mean mode, forward and
   backward (checked: 48 forward and 32 backward launches a step).  4
   steps on the card, timed and profiled as in phase 3; the CPU runs the
   first 2 (its R-GCN step takes tens of seconds), whose plans (with their
   relation ids), ``plan_stats`` and losses must agree with the card's.
   In every training phase the initial weights must be equal on both
   devices and each parameter's step-0 gradient agree within ``1e-5`` of
   its largest entry (``check_gradients``); the R-GCN's final weights are
   not compared (the CPU stops at step 2).
7. Phase 3's graph again: GraphSAGE (phase 3's widths) sampled by NS,
   trained and checked as in phase 3 (``phase_compiled`` against the
   eager build only: the training holds its replays against the CPU's);
   one cooperative ``plan_at(0)`` each
   with the ``rw`` and ``full`` samplers, every integer leaf equal to the
   CPU's; and the work curves of Thm 3.1/3.2 (``measure_work_curve``, 3
   layers, 2 trials at batch sizes 64, 256 and 1,024) for ``ns``,
   ``labor0``, ``labor*`` and ``rw``, counts equal to the CPU's.
8. Dependent minibatching (§4.2, the κ sweep of Fig. 5) on phase 6's graph
   and 768 features: phase 3's engine configuration with the tiered cache
   on (``CacheConfig(enabled=True)``: 65,536 rows and 8 ways per PE), in
   cooperative and independent mode (P = 4, local batch 64), at κ = 1,
   16, 256 and ∞, 16 steps of ``engine.stream(16, prefetch=2,
   fetch_features=True)`` each.  Every step's ``plan.input_ids`` go to the
   exact LRU oracle (``CooperativeCacheArray``, host), a card
   ``ClockCache`` and a CPU ``ClockCache``, and in independent mode to
   ``count_duplicates_across_pes``.  Checked: at every (mode, κ) the card
   ``ClockCache``'s per-PE hits, misses and requests equal the engine's
   tiered store's and the CPU replay's; at κ = 16 the first 4 items of a
   ``prefetch=0`` stream equal the ``prefetch=2`` stream's and the first
   2 equal a CPU stream's (integer plan leaves, seeds, features bit for
   bit, and the tiered counters), and those 4 items' plans (replays of the
   engine's captured ``plan_at``, captured once) equal the eager build of
   the same step; the LRU miss rate at κ = ∞ is below the
   one at κ = 1 in both modes.  Printed: miss rates, the CLOCK-LRU gap,
   the κ = 1/∞ ratio, rows fetched host->device, duplicates, wall ms per
   step (prefetch 0 against 2 at κ = 16), launches per step, peak memory.
   The tiered store's two programs are captured once at every (mode, κ)
   (keyed by the stream's ``(P, n)``; capture ms and pool bytes printed at
   κ = 16).
9. Multi-process cooperative training: phase 3's configuration with
   ``executor="shard"``, one PE per process (``torch.multiprocessing``,
   ``spawn``; a FileStore and a collective timeout, so a rank that dies
   fails the phase), each rank calling ``train_gnn`` on phase 3's graph
   and dataset, made once here and handed to the ranks.  9a: 4 ranks on
   the one card over gloo (CUDA tensors, which gloo stages through host
   memory), through the staged step (``stage_times=True``: the step
   program's spans read after each step; gloo's collectives run on the
   host and cannot be captured, so it runs eagerly); 9b: 1 rank over NCCL
   (P = 1), so NCCL's all-to-all and all-reduce run on the card: first
   through the step program with stage times (one captured CUDA graph,
   the collectives and the spans in it), then the same steps through the
   program's body run eagerly (``program.fn``).
   The kernels were built in phase 0; a rank only loads them.  Checked:
   every step's stacked plan (``stack_plan``) equal bit for bit to phase
   3's card ``SimExecutor`` plan (9b: to a P = 1 ``SimExecutor``'s on the
   card), losses within ``rtol=1e-4`` of its, step-0 gradients within
   ``1e-5`` of each parameter's largest ``|g|``, every rank's weights
   equal bit for bit after every step, and each rank's launches per step
   (``frontier_gather`` L, ``unique_compact`` 2L + 1, ``gather`` 1,
   ``spmm`` L, its backward L - 1); 9b's captured run against its eager
   run: plans bit for bit, losses, final weights (``atol=1e-4``) and
   step-0 gradients, one capture of the step program and of the plan
   program.  Printed per rank and step of a run with stage times (9a,
   9b's captured): its spans' ms
   (plan, gather, forward+backward, all-reduce and Adam), and each
   direction's exchanges (ids, embeddings forward, gradients backward)
   with their bytes and span ms; 9b's capture (ms, pool bytes, launches
   a replay), its captured steps' ms and its plan replays' ms; peak
   memory per rank.  On one card the exchange crosses host memory between
   processes: its time says nothing about an NVLink all-to-all.
10. The examples and the analyzer.  10a: the four ``examples/*_torch.py``
   at their own widths on the card, then on the CPU;
   ``train_cooperative_gnn_torch`` at 20 steps (its default is 300) and
   on the card also with ``plan_backend="fused"``.  Checked card against
   CPU: feature rows fetched, LRU miss rates per κ, serve accounting and
   ``compiles`` (1 a bucket) equal; losses within ``rtol=1e-4``, logits
   within ``atol=1e-4``.  10b: ``run_analysis`` over ``src/repro_torch``
   on the card (lint, contracts on the seven CUDA wrappers, trace); prints
   the RA001/RA002/RA004 sites, each wrapper's RA100, and each trace
   entry's host syncs per call (dispatched ops and sync-debug warnings)
   and whether its op sequence stayed the same; then the syncs of one
   served batch, of ``GNNServer.hot_path`` and of the tiered gather alone
   (one: the missed ids' read) at each of phase 2's buckets, and of one
   replay of phase 3's captured train step, of the shard executor's plan
   and train-step programs on a one-rank NCCL group in this process, and
   of ``make_train_step``'s program at a reduced gemma2 (none each).
   Fails on RA005, RA107, RA199 or RA299, or on other sync counts.
11. The LM pool (``repro_torch.models.transformer``, no CUDA kernel of
   its own: its products are cuBLAS calls, the rest plain torch ops).
   11a: each of the ten architectures at its reduced size, ``init_lm`` on
   the card (bit for bit the CPU's draw) and the same weights copied to
   the CPU: ``forward_train``
   logits within ``atol=1e-4``; ``prefill_decode`` at batch 4, prompt 16:
   logits and every cache within ``atol=1e-4``, ``pos`` equal; 8 greedy
   tokens equal; for MoE, layer 0's routes (experts and expert tables)
   equal on a seeded input.  11b: gemma2-2b at its published widths and
   depth (26 layers, d 2304, 8/4 heads of 256, d_ff 9216, vocab 256,000,
   float32, TF32 off): ``init_lm`` on the card; the decode step is one
   captured CUDA graph a batch, cache length and state
   (``decode_program``, captured once a key); ``prefill_decode`` (batch
   4, prompt 16) bit for bit equal to stepping ``make_serve_step`` over
   the prompt (logits, every cache, 24 greedy tokens), and the 24 greedy
   tokens equal to ``forward_decode`` run eagerly from the same state
   (its ms a step printed beside the captured one's); ``forward_train``
   at S 64 within ``3e-3 * max|logits|`` of stepped decode;
   ``make_prefill_step`` at batch 4, S 2,048; at 2 layers, card against
   CPU (weights copied from the card): logits within ``atol=1e-4``, 8
   greedy tokens equal.  Printed beside the card's name and power limit:
   decode ms a step (median of 24, each ended by a sync), tokens/s, the
   step's memory bound (parameter bytes over 3.35 TB/s), ``prefill_decode``
   and ``make_prefill_step`` ms, peak memory, one decode step's CUDA
   launches and idle share under the profiler, and its host syncs (the
   analyzer's trace pass).
12. LM training (``repro_torch.launch.steps.make_train_step``: chunked CE,
   remat, autograd, ``adam_update``; on the card one captured CUDA graph a
   batch shape, its first call the eager warm-up).  12a: each of the ten
   architectures at its reduced size, the same ``init_lm`` weights on the
   card and the CPU: ``lm_loss`` within ``rtol=1e-5``, each parameter's
   step-0 gradient within 1e-5 of its largest ``|g|`` (the SSD's ``A_log``
   5e-5), 3 steps' losses within ``rtol=1e-4`` and falling, the card's
   through the captured program (one capture) and within ``rtol=1e-4`` of
   the program's body run eagerly on the card; then a reduced
   gemma2 with ``cooperative_embed`` (B·S > V): the card's kernel route
   (``unique_compact``, then ``gather`` twice) and the CPU's plain route
   give ``embed[tokens]`` bit for bit, the gradients held as above, and
   the route's host syncs by the trace pass (0 expected, where
   ``torch.unique`` on the same ids syncs).  12b: gemma2-2b at its
   published widths and depth, float32, TF32 off, remat on, at batch 4,
   S 2,048: first the program's body run eagerly (a warm step, one timed,
   the peak memory that 13b holds its trace to, one under
   ``FlopCounterMode`` and one split into forward, backward and Adam, each
   stage ended by a sync), then ``make_train_step``: the eager warm-up and
   capture (capture ms, pool bytes) and 2 timed replays (each to the
   loss's read): step ms, tokens/s, ``model_flops`` (6·N·D) over the step
   time against 67 TFLOP/s, peak memory with the pool, one replay under
   the profiler (CUDA kernels, float32 GEMMs, idle share) and one under
   the trace pass (0 host syncs); then at 2 layers of the same widths the
   captured program against its body run eagerly over 3 steps at batch 4
   x S 2,048 (a full-size copy of the weights and moments would not fit
   beside them), and card against CPU at S 64.  12c: whisper-tiny
   at its published widths with ``cooperative_embed``, batch 32 x S 2,048
   (65,536 Zipf token slots over 51,865 ids): the kernel route's rows bit
   for bit equal to the plain versions' on the card and to
   ``embed[tokens]``; loss and gradients against the plain
   ``embed[tokens]`` route (1e-5 as above); one train step; the distinct
   ids against the slots; phase-1 rows for ``unique_compact`` and both
   ``gather`` calls at these shapes.  The launch counts are zeroed right
   before 12c's second train step (on a card a replay of the captured
   program) and read right after it: the step must launch
   ``unique_compact`` once and ``gather`` twice, and no other kernel.
13. The dry-run (``repro_torch.launch.dryrun``), each part in a child
   process, so no process group enters this one.  13a: ``python -m
   repro_torch.launch.dryrun`` for gemma2-2b ``train_4k`` and ``--gnn`` on
   the single-pod mesh (256 fake ranks), on fake CUDA and on fake CPU
   tensors: every record ``ok``, dot FLOPs and collective bytes equal
   across the two, the GNN's fake-CUDA record listing the fused plan's
   ``frontier_gather`` and ``unique_compact`` launches (recorded, not
   run); each record's terms, bottleneck, peak and trace time printed.
   13b: 12b's configuration (gemma2-2b, float32, remat, batch 4 x S
   2,048) traced on a one-device mesh: its dot FLOPs within 1% of
   ``FlopCounterMode`` over one real 12b step, its peak within 10% of
   12b's ``max_memory_allocated`` (less what earlier phases held), its
   roofline terms beside 12b's measured step.  13c: the dry-run's GNN
   step (``make_coop_train_step``, P = 1) run for real on one NCCL rank
   on phase 3's graph at papers100M widths: float32 under
   ``FlopCounterMode`` (FLOPs and peak within 1% and 10% of its own trace
   on fake CUDA tensors), float64 on the card against float64 on the CPU
   (a gloo group): plans bit-equal, loss ``rtol=1e-4``, step-0 gradients
   within 1e-5 of each parameter's largest ``|g|``.

The second-to-last line of output is a JSON object with one entry per
kernel, at its largest shape on a path; the last line is ``{"ok": true,
"device": {...}}``.  Any failed phase exits non-zero without that line.  Without a CUDA device, or
without the rest of the repository next to this file, it exits 1.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate, NVIDIA data sheet
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet): the
# published peak nearest the kernels' 32-bit integer compares and adds
SCALAR_OPS_PER_S = 67e12
ATOL = 1e-4
STEADY_REQUESTS, STEADY_RPS = 4000, 1000.0
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-4  # losses; final weights
GRAD_RTOL = 1e-5  # step-0 gradients, of each parameter's largest |g|
TRAIN_STEPS, PROFILE_STEPS = 4, 2
KERNELS = {
    "frontier_gather": {
        "source": "src/repro_torch/kernels/frontier_gather/frontier_gather.cu",
        "replaces": "src/repro/kernels/frontier_gather/kernel.py:61",
    },
    "unique_compact": {
        "source": "src/repro_torch/kernels/unique_compact/unique_compact.cu",
        "replaces": "src/repro/kernels/unique_compact/kernel.py:89",
    },
    "tag_probe": {
        "source": "src/repro_torch/store/tag_probe.cu",
        "replaces": "src/repro/store/kernel.py:63",
    },
    "gather": {
        "source": "src/repro_torch/kernels/gather/gather.cu",
        "replaces": "src/repro/kernels/gather/kernel.py:49",
    },
    "spmm": {
        "source": "src/repro_torch/kernels/spmm/spmm.cu",
        "replaces": "src/repro/kernels/spmm/kernel.py:43",
    },
    "spmm_backward": {
        "source": "src/repro_torch/kernels/spmm/spmm.cu",
        "replaces": "src/repro/kernels/spmm/kernel.py:43",
    },
    "seg_softmax": {
        "source": "src/repro_torch/kernels/seg_softmax/seg_softmax.cu",
        "replaces": "src/repro/kernels/seg_softmax/kernel.py:33",
    },
    "seg_softmax_backward": {
        "source": "src/repro_torch/kernels/seg_softmax/seg_softmax.cu",
        "replaces": "src/repro/kernels/seg_softmax/kernel.py:33",
    },
    "expand_indptr": {
        "source": "src/repro_torch/kernels/expand_indptr/expand_indptr.cu",
        "replaces": "src/repro/kernels/expand_indptr/kernel.py:33",
    },
}
# the kernels each path must launch (R-GCN and GraphSAGE launch spmm in
# its mean mode only)
PATH_KERNELS = {
    "serve": ("frontier_gather", "unique_compact", "tag_probe", "spmm"),
    "train": ("frontier_gather", "unique_compact", "gather", "spmm", "spmm_backward"),
    "train_gat": ("frontier_gather", "unique_compact", "gather", "seg_softmax",
                  "seg_softmax_backward"),
    "coo": ("expand_indptr",),
    "train_rgcn": ("frontier_gather", "unique_compact", "gather", "spmm", "spmm_backward"),
    "train_sage": ("frontier_gather", "unique_compact", "gather", "spmm", "spmm_backward"),
    "plan_rw": ("unique_compact",),
    "plan_full": ("frontier_gather", "unique_compact"),
    "curves": ("frontier_gather",),
    "dependent": ("frontier_gather", "unique_compact", "tag_probe"),
    "train_shard": ("frontier_gather", "unique_compact", "gather", "spmm", "spmm_backward"),
    "examples": ("frontier_gather", "unique_compact", "gather", "spmm", "spmm_backward"),
    "analysis": ("frontier_gather", "unique_compact", "tag_probe", "gather", "spmm",
                 "seg_softmax", "expand_indptr"),
    "lm": (),  # the LM pool serves on cuBLAS and plain torch ops, none of the seven
    # LM training: the cooperative embedding's dedup and row reads (12c's step)
    "lm_train": ("unique_compact", "gather"),
}
# the R-GCN of phase 6: the JAX package's mag240M widths
# (src/repro/launch/gnn_dryrun.py, SCALE_MAG)
RGCN_CFG = dict(model="rgcn", num_layers=3, in_dim=768, hidden_dim=1024, num_classes=153,
                num_relations=4)
RGCN_CPU_STEPS = 2  # the CPU reference's steps for the R-GCN (phase 6)
CURVE_BATCHES = [64, 256, 1024]
# seg_softmax against its plain version on the card: the kernel calls CUDA's
# expf where the plain version calls torch.exp; the backward's bound scales
# with the largest output gradient
SEG_ATOL, SEG_BWD_ATOL = 1e-6, 1e-6
# the one-warp-per-(row, head) seg_softmax kernels that the row-per-warp
# design replaced: device ms by graph replay at plan layers 0, 1, 2, as
# this script measured them on an H100 80GB HBM3 at 700 W (PERF.md)
SEG_WAS_MS = {"seg_softmax": (0.00330, 0.00407, 0.04430),
              "seg_softmax_backward": (0.00257, 0.00364, 0.03469)}
# the thread-per-float4 gather kernel that the lane-group design replaced:
# device ms by graph replay at each path's step-0 input gather (GCN and
# GraphSAGE d = 64, R-GCN d = 768; n = 1,048,576), as this script measured
# them on an H100 80GB HBM3 at 700 W (PERF.md)
GATHER_WAS_MS = {"train": 0.09774, "train_sage": 0.09798, "train_rgcn": 1.18858}
GATHER_ALL_VALID = 262_144  # ids of the off-path all-valid gather row
# graph replays before each timed window: at least this many calls, and
# this many ms of them (graph_ms)
WARM_CALLS, WARM_MS = 10, 20.0
PROFILE_TRIES = 3  # traces profiled_kernels takes while they hold no CUDA record
# phase 8: the κ sweep (None is κ = ∞), steps per (mode, κ), and at κ = 16
# the items held against prefetch 0 and against the CPU
DEP_MODES, DEP_KAPPAS, DEP_STEPS = ("cooperative", "independent"), (1, 16, 256, None), 16
DEP_PREFETCH_ITEMS, DEP_CPU_ITEMS = 4, 2
# the steps at which a captured plan_at is held against its eager build and
# the CPU's: c = 0, c > 0 and the kappa = 16 window edge (15 -> 16 -> 17)
COMPILED_STEPS = (0, 1, 15, 16, 17)
# phase 9: how long a collective waits for the other ranks, and how long a
# run of the ranks may take, process start included, before it is killed
SHARD_COLLECTIVE_S, SHARD_DEADLINE_S = 120, 300
# phase 10: the training example's steps (its default is 300)
EXAMPLE_TRAIN_STEPS = 20
# phase 11: batch, prompt and new tokens (examples/serve_lm.py's), greedy
# tokens held card against CPU, the teacher-forced length, the prefill
# length (two of the flash path's 1,024-key blocks) and the reference's
# train/decode bound, relative to the largest |logit|
LM_BATCH, LM_PROMPT, LM_NEW, LM_GREEDY = 4, 16, 24, 8
LM_TRAIN_S, LM_PREFILL_S, LM_CONSISTENCY = 64, 2048, 3e-3
# phase 12: make_train_step steps held card against CPU (12a), the loss's
# bound, the SSD's A_log gradient bound (a float32 sum with heavy
# cancellation: the JAX package's own float32 gradient is 1.19e-5 of its
# largest |g| from a float64 evaluation, tests/test_torch_lm_train.py),
# the card-against-CPU sequence length (12a, 12b at 2 layers) and the
# cooperative embedding's check length there; 12b's batch, sequence and
# timed steps; 12c's batch and sequence (65,536 token slots over
# whisper-tiny's 51,865 ids)
LM_TRAIN_STEPS, LM_LOSS_RTOL, SSD_DECAY_RTOL = 3, 1e-5, 5e-5
LM_TRAIN_CHECK_S, COOP_CHECK_S = 64, 256
LM_TRAIN_B, LM_TRAIN_SEQ, LM_TRAIN_TIMED = 4, 2048, 2
COOP_B, COOP_S = 32, 2048
# one train step with the cooperative embedding on a card: the dedup once,
# then the distinct rows' read and the slots' expansion (the backward is
# plain torch)
COOP_STEP_LAUNCHES = {"unique_compact": 1, "gather": 2}
# phase 13: how long a dry-run child may take; the traced FLOPs' and
# peak's bounds against a measured step (relative)
DRYRUN_TIMEOUT_S, DRYRUN_FLOP_RTOL, DRYRUN_PEAK_RTOL = 300, 0.01, 0.10


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median time of one call between CUDA events recorded around it on the
    stream: device time plus any host gap inside the call (launch latency)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


@functools.cache
def capture_stream():
    """The side stream every CUDA graph is captured on.  A backward
    yardstick builds its autograd graph on it too: autograd runs each
    backward op on its forward op's stream, and only this stream is being
    captured."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events (no host gaps), after
    warm-up replays (at least ``WARM_CALLS`` calls and ``WARM_MS`` of them):
    the first passes of a new graph over the outputs it allocated run slower
    on the H100, most of all at the gather's 3.2 GB output."""
    import math

    import torch

    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    warm = max(math.ceil(WARM_CALLS / calls), math.ceil(WARM_MS / max(a.elapsed_time(b), 1e-3)))
    for _ in range(warm):
        graph.replay()
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (calls * replays)


def cuda_kernel_us(prof) -> list:
    """(device us, calls, name) of every CUDA kernel/copy in a profile; the
    device-side ranges of ``record_function`` spans are not kernels."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
            rows.append((us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profiled_kernels(fn, iters: int = 20) -> list:
    """(device us, launches, name) per call of each kernel (and memset) that
    ``fn`` launches, from a torch.profiler trace.  The card machine's tracer
    drops kernel records, and once dropped every record of a trace: a trace
    with no CUDA record at all is taken again, up to ``PROFILE_TRIES`` times
    (the callers' checks then see the new trace)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = []
        for us, count, key in cuda_kernel_us(prof):
            name = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
            out.append((us / iters, count / iters, name.group(1) if name else key[:24]))
        if out:
            return out
        print(f"profiler: no CUDA record in trace {attempt + 1} of {PROFILE_TRIES}", flush=True)
    return out


def launches_per_call(name: str, fn, calls: int = 20) -> float:
    """Launches of kernel ``name`` per call of ``fn``, by its wrapper's
    counter.  Beside a profile, which names every kernel a call makes:
    the card machine's tracer drops some of a run's kernel records (up to
    6 of 20 calls of one ``frontier_gather``), so its counts are a
    floor."""
    from repro_torch.kernels import LAUNCHES

    before = LAUNCHES.get(name, 0)
    for _ in range(calls):
        fn()
    return (LAUNCHES.get(name, 0) - before) / calls


def kernel_split(split: list) -> str:
    """``profiled_kernels``' list as text: device us and launches per call."""
    return ", ".join(f"{name} {us:.2f} us x{count:g}" for us, count, name in split)


def device_ms(fn, iters: int = 20):
    """Device time of one call that cannot be graph-captured (it syncs):
    its CUDA kernels summed from a torch.profiler trace, None if empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for us, _, _ in cuda_kernel_us(prof))
    return total_us / 1e3 / iters if total_us > 0 else None


def syncs(fn) -> bool:
    """Whether one call of ``fn`` waits for the device (PyTorch's sync
    debug mode warns on every synchronizing CUDA operation)."""
    import warnings

    import torch
    from repro_torch.analysis.trace import SYNC_WARNING

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return any(SYNC_WARNING in str(w.message) for w in caught)


GRAPH, PROFILER = "graph replay", "profiler sum (syncs)"


def timings(fn, plain, library=None, calls: int = 20, plain_syncs: bool = False,
            library_syncs: bool = False) -> dict:
    """Device time of the kernel, its plain version and a library yardstick,
    each by CUDA graph replay of ``calls`` calls, and each one's per-call
    event time.  A plain version or library call that syncs (flagged by
    ``plain_syncs`` / ``library_syncs``, and checked to sync) cannot be
    captured: it gets its profiled kernel sum instead, and beside a
    library call that syncs so does the kernel (``kernel_profiler_ms``),
    for a like-for-like pair.  A call not flagged must capture, or the
    phase fails."""
    out = {"ms": graph_ms(fn, calls), "event_ms": event_ms(fn),
           "plain_ms": device_ms(plain) if plain_syncs else graph_ms(plain, calls),
           "plain_event_ms": event_ms(plain), "plain_method": PROFILER if plain_syncs else GRAPH,
           "library_ms": None, "library_event_ms": None, "library_method": None}
    for name, f, flagged in (("plain", plain, plain_syncs), ("library", library, library_syncs)):
        if f is not None and flagged:
            check(syncs(f), f"{name} call flagged as syncing does not sync: graph-time it")
    if library is not None:
        out["library_ms"] = device_ms(library) if library_syncs else graph_ms(library, calls)
        out["library_event_ms"] = event_ms(library)
        out["library_method"] = PROFILER if library_syncs else GRAPH
    if library_syncs:
        out["kernel_profiler_ms"] = device_ms(fn)
    return out


# --------------------------------------------------------------------------
# phase 0
# --------------------------------------------------------------------------
def phase0() -> dict:
    import torch
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s for {sorted(paths)} into {_build.BUILD_DIR}")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    # the seven ported kernels and the span marker (no TPU kernel; the
    # spans' card tests time it)
    want = {Path(meta["source"]).stem for meta in KERNELS.values()} | {"span_marker"}
    check(set(paths) == want, f"built {sorted(paths)}, want {sorted(want)}")
    return {"card": card, "build_s": build_s}


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------
def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def phase1(ds, caps, cache_rows: int) -> dict:
    """Each kernel against its plain version at the serving shapes."""
    import numpy as np
    import torch
    from repro_torch.core.graph import INVALID
    from repro_torch.store import hash_set

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    g = ds.graph
    V, D = g.num_vertices, g.max_degree
    out = {}

    # frontier_gather at the bucket-64 frontiers (caps[0], caps[1]) x max_degree
    rows = []
    for n in caps[:-1]:
        seeds = rng.choice(V, size=n, replace=False).astype(np.int32)
        seeds[rng.random(n) < 0.1] = INVALID
        s = torch.from_numpy(np.sort(seeds)).to(dev)
        rows.append(frontier_row(g, s, ["serve"], "1/batch", "serve"))
    out["frontier_gather"] = rows

    # unique_compact at m = cap_l * (1 + max_degree) ids, cap = cap_{l+1}
    rows = []
    for l in range(len(caps) - 1):
        m, cap = caps[l] * (1 + D), caps[l + 1]
        ids = rng.integers(0, V, size=m).astype(np.int32)
        ids[rng.random(m) < 0.5] = INVALID          # masked neighbor slots
        ids[: m // 4] = ids[rng.integers(0, m // 4, m // 4)]  # shared neighbors
        rows.append(dedup_row(torch.from_numpy(ids).to(dev), cap, ["serve"], "1/batch",
                              f"serve hop {l}"))
    out["unique_compact"] = rows

    # tag_probe at n = the unique ids of one batch, S = capacity / 8, W = 8
    W = 8
    S = cache_rows // W
    tags = rng.integers(0, V, size=(S, W)).astype(np.int32)
    tags[rng.random((S, W)) < 0.3] = INVALID
    ids = np.unique(rng.integers(0, V, size=caps[-1]).astype(np.int32))
    ids_t = torch.from_numpy(ids).to(dev)
    sets = hash_set(ids_t, S)
    hit = rng.random(len(ids)) < 0.5
    tags[sets.cpu().numpy()[hit], rng.integers(0, W, hit.sum())] = ids[hit]
    out["tag_probe"] = [probe_row(torch.from_numpy(tags).to(dev), sets, ids_t, ["serve"],
                                  "1/batch", "serve")]

    report_bounds(out)
    return out


def probe_row(tags, sets, ids, paths: list, per: str, label: str) -> dict:
    """``tag_probe`` on ``(tags (S, W), sets, ids)`` against its plain
    version, equal bit for bit, from one CUDA kernel a call.  Bytes: the
    ids and sets read and the ways written once, each probed set's W tags
    read once; operations: per id the row address, then one compare per
    way up to the first match."""
    import torch
    from repro_torch.store import probe_ref, tag_probe_cuda

    S, W = tags.shape
    n = ids.shape[0]
    got = tag_probe_cuda(tags, sets, ids)
    want = probe_ref(tags, sets, ids)
    err = int((got != want).sum())
    check(err == 0, f"tag_probe {label} n={n}: {err} entries differ from plain")
    call = lambda: tag_probe_cuda(tags, sets, ids)
    split = profiled_kernels(call)
    check(len(split) == 1 and split[0][1] <= 1 and "tag_probe" in split[0][2]
          and launches_per_call("tag_probe", call) == 1,
          f"tag_probe {label}: not one kernel a call: {split}")
    return dict(
        shape=f"{label}: n={n} S={S} W={W} hits={int((want >= 0).sum())}",
        bytes=4 * n * 3 + 4 * W * int(torch.unique(sets).numel()),
        ops=n + int(torch.where(want >= 0, want + 1, W).sum()),
        max_abs_err=max_abs_err(got, want), paths=paths, per=per,
        extra_split=kernel_split(split),
        **timings(call, lambda: probe_ref(tags, sets, ids)),
    )


def report_bounds(out: dict) -> None:
    """Add each row's bound and print it beside the measured times."""
    for name, rows in out.items():
        for r in rows:
            bytes_ms = 1e3 * r["bytes"] / HBM_BYTES_PER_S
            ops_ms = 1e3 * r["ops"] / SCALAR_OPS_PER_S
            r["bound_ms"] = max(bytes_ms, ops_ms)
            r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
            agree = ("equal bit for bit" if r["max_abs_err"] == 0
                     else f"max abs err {r['max_abs_err']:.3e}")
            where = ", ".join(r["paths"]) + f" ({r['per']})" if r["paths"] else "off the paths"
            prof = (f" (kernel by profiler sum {r['kernel_profiler_ms']})"
                    if "kernel_profiler_ms" in r else "")
            print(f"phase1 {name} [{r['shape']}] {where}: {agree}; device ms "
                  f"kernel {r['ms']:.5f}{prof} plain {r['plain_ms']:.5f} "
                  f"({r['plain_method']}) library {r['library_ms']} "
                  f"({r['library_method']}); event ms kernel {r['event_ms']:.5f} plain "
                  f"{r['plain_event_ms']:.5f} library {r['library_event_ms']}; "
                  f"bound {r['bound_ms']:.6f} ms by {r['bound_by']} (bytes "
                  f"{r['bytes']}, ops {r['ops']})"
                  + (f"; fill_ms {r['fill_ms']:.5f} (kernel {r['ms'] / r['fill_ms']:.4f} x "
                     "fill)" if "fill_ms" in r else "")
                  + "".join(f"; {k} {r[k]}" for k in r if k.startswith("extra_")))


def frontier_row(g, seeds, paths: list, per: str, label: str) -> dict:
    """``frontier_gather`` on ``seeds`` of graph ``g`` against its plain
    version: the table and the mask equal bit for bit, from one CUDA kernel
    a call (profiled through the public wrapper, the path's entry point).
    Bytes: the seeds, two indptr words per valid seed and the valid rows'
    capped neighbor ids read once, the table and the mask written once;
    operations: per seed the INVALID test and the degree, per slot
    ``k < deg`` and ``off + k``.  Beside the kernel, the parent design's
    separate mask op (``nbr != INVALID``) at the same shape, by graph
    replay (``extra_mask_op_ms``)."""
    import torch
    from repro_torch.core.graph import INVALID
    from repro_torch.kernels.frontier_gather import (
        frontier_gather,
        frontier_gather_cuda,
        frontier_gather_ref,
    )

    D = g.max_degree
    n = seeds.shape[0]
    nbr, mask = frontier_gather_cuda(g.indptr, g.indices, seeds, D)
    want = frontier_gather_ref(g.indptr, g.indices, seeds, D)
    for name, a, b in (("table", nbr, want[0]), ("mask", mask, want[1])):
        err = int((a != b).sum())
        check(err == 0, f"frontier_gather {label} n={n}: {err} {name} entries differ from plain")
    call = lambda: frontier_gather(g.indptr, g.indices, seeds, D)
    split = profiled_kernels(call)
    check(len(split) == 1 and split[0][1] <= 1 and "frontier_gather" in split[0][2]
          and launches_per_call("frontier_gather", call) == 1,
          f"frontier_gather {label} n={n}: not one kernel a call: {split}")
    valid = seeds != INVALID
    sv = seeds[valid].long()
    deg = (g.indptr[sv + 1] - g.indptr[sv]).clamp(max=D)
    return dict(
        shape=f"{label}: n={n} D={D} valid seeds={int(valid.sum())} slots={int(deg.sum())}",
        bytes=4 * n + 8 * int(valid.sum()) + 4 * int(deg.sum()) + 4 * n * D + n * D,
        ops=2 * n + 2 * n * D, max_abs_err=max(max_abs_err(nbr, want[0]),
                                               max_abs_err(mask, want[1])),
        paths=paths, per=per, extra_split=kernel_split(split),
        extra_mask_op_ms=graph_ms(lambda: nbr != INVALID),
        **timings(lambda: frontier_gather_cuda(g.indptr, g.indices, seeds, D),
                  lambda: frontier_gather_ref(g.indptr, g.indices, seeds, D)),
    )


def phase1_train(engine) -> dict:
    """Every kernel of the training path against its plain version at the
    path's shapes: the inputs come from step 0's plan of ``engine`` (PE
    0's frontiers and index tables) and features from a numpy seed.  Each
    row names the paths that run its shape and its launches per step."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    plan = engine.plan_at(0)
    P = plan.seed_ids.shape[0]
    per_pe = f"{P}/step"  # one launch per PE
    train = ["train", "train_gat"]
    out = {"frontier_gather": [], "unique_compact": [], "gather": []}
    dedups = plan_rows(out, engine, plan, train, per_pe)
    deepest = sorted(dedups, key=lambda t: -t[0].numel())[:2]
    dedup_whole(deepest)
    add_row(out, "gather", gather_row(engine.store.features, plan.input_ids, train, "1/step"))
    # the shard path (phase 9): a rank builds and computes PE 0's shapes
    # (rank 0's plan is PE 0's row) and gathers only its own input ids
    shard, per_rank = ["train_shard"], "1/rank step"
    plan_rows(out, engine, plan, shard, per_rank)
    add_row(out, "gather", gather_row(engine.store.features, plan.input_ids[0], shard,
                                      per_rank))
    caps, L = engine.caps, len(plan.layers)

    # spmm at every layer's (S~ rows, owned rows, d_in) for PE 0: the GCN
    # runs the forward at every layer, the backward where its input needs a
    # gradient (not plan layer L-1, which reads the raw features)
    fwd, bwd = [], []
    for l, layer in enumerate(plan.layers):
        d = 64 if l == L - 1 else 256
        f, b = spmm_rows(layer.nbr_idx[0], layer.mask[0], caps.tilde_caps[l], d, rng,
                         paths=["train", *shard], per=f"{per_pe}; {per_rank} on train_shard",
                         backward_on_path=l < L - 1, label=f"layer {l}")
        fwd.append(f)
        bwd.append(b)
    out["spmm"], out["spmm_backward"] = fwd, bwd

    # seg_softmax (GAT, 4 heads) and expand_indptr (layer_to_coo) on every
    # layer's mask of PE 0
    fwd, bwd, coo = [], [], []
    for l, layer in enumerate(plan.layers):
        f, b = seg_softmax_rows(layer.mask[0].contiguous(), 4, rng)
        fwd.append(dict(f, paths=["train_gat"], per=per_pe,
                        extra_was=f"{SEG_WAS_MS['seg_softmax'][l]} ms (warp per head)"))
        bwd.append(dict(b, paths=["train_gat"], per=per_pe,
                        extra_was=f"{SEG_WAS_MS['seg_softmax_backward'][l]} ms "
                                  "(warp per head)"))
        coo.append(dict(expand_indptr_row(layer.mask[0]), paths=["coo"], per="1/coo layer"))
    out["seg_softmax"], out["seg_softmax_backward"], out["expand_indptr"] = fwd, bwd, coo
    report_bounds(out)
    return out


# every phase-1 row by kernel and inputs (shared_row)
ROWS_BY_INPUT: list = []


def same_inputs(a: tuple, b: tuple) -> bool:
    import torch

    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
        elif (x.shape != y.shape or x.dtype != y.dtype or x.device != y.device
              or not torch.equal(x, y)):
            return False
    return True


def shared_row(name: str, inputs: tuple, paths: list, per: str, make):
    """The row of kernel ``name`` on ``inputs`` (tensors and ints), made by
    ``make()`` -- unless a row was made on equal inputs before: that row
    then also names ``paths`` (and their launches ``per``), and this
    returns None."""
    for n, ins, row in ROWS_BY_INPUT:
        if n == name and same_inputs(ins, inputs):
            row["paths"] = row["paths"] + [p for p in paths if p not in row["paths"]]
            if per != row["per"]:
                row["per"] += f"; {per} on {', '.join(paths)}"
            print(f"phase1 {name} [{row['shape']}]: same inputs on {', '.join(paths)}")
            return None
    row = make()
    ROWS_BY_INPUT.append((name, inputs, row))
    return row


def add_row(out: dict, name: str, row) -> None:
    if row is not None:
        out.setdefault(name, []).append(row)


def plan_dedups(engine, plan) -> list:
    """PE 0's 7 dedups of a cooperative plan (build_cooperative_minibatch),
    ``(ids, cap, label)`` each, the ids rebuilt from the plan: the local
    seeds; per hop, the frontier with its sampled neighbors, and the ids
    peers request here."""
    import torch
    from repro_torch.core.graph import INVALID

    dev = plan.layers[0].seeds.device
    caps = engine.caps
    dedups = [(torch.from_numpy(engine.seed_batch(0)[0]).to(dev), caps.caps[0], "seeds")]
    L = len(plan.layers)
    for l, layer in enumerate(plan.layers):
        S_l, tilde = layer.seeds[0], layer.tilde_ids[0]
        nbr = torch.where(layer.mask[0], tilde[layer.nbr_idx[0].clamp(min=0).long()], INVALID)
        dedups.append((torch.cat([S_l, nbr.reshape(-1)]), caps.tilde_caps[l], f"hop {l}"))
        nxt = plan.layers[l + 1].seeds[0] if l + 1 < L else plan.input_ids[0]
        req_idx = layer.req_idx[0]
        req = torch.where(req_idx >= 0, nxt[req_idx.clamp(min=0).long()], INVALID)
        dedups.append((req.reshape(-1), caps.caps[l + 1], f"requests {l}"))
    return [(ids.contiguous(), cap, label) for ids, cap, label in dedups]


def plan_rows(out: dict, engine, plan, paths: list, per: str, tag: str = "",
              frontiers: bool = True) -> list:
    """Rows of ``frontier_gather`` at PE 0's frontier of every layer of the
    cooperative ``plan`` (if ``frontiers``) and of ``unique_compact`` at
    PE 0's 7 dedups, added to ``out`` (through :func:`shared_row`);
    returns the dedups."""
    g = engine.graph
    if frontiers:
        for l, layer in enumerate(plan.layers):
            seeds = layer.seeds[0].contiguous()
            add_row(out, "frontier_gather", shared_row(
                "frontier_gather", (g.indptr, g.indices, seeds), paths, per,
                lambda: frontier_row(g, seeds, paths, per, f"{tag}layer {l}")))
    dedups = plan_dedups(engine, plan)
    for ids, cap, label in dedups:
        add_row(out, "unique_compact", shared_row(
            "unique_compact", (ids, cap), paths, per,
            lambda: dedup_row(ids, cap, paths, per, f"{tag}{label}")))
    return dedups


def gather_row(table, ids, paths: list, per: str):
    """``gather`` of ``ids`` (a plan's input ids, all PEs) from ``table``
    against its plain version, equal bit for bit (through
    :func:`shared_row`).  Bytes: the ids, each distinct valid row read
    once, the output written once.  Beside the kernel: the card's own
    write rate for the same output, ``torch.zeros((n, d))`` by graph
    replay (``fill_ms``), and the replaced design's time on the path
    (``extra_was``, ``GATHER_WAS_MS``)."""
    import torch
    from repro_torch.core.graph import INVALID
    from repro_torch.kernels.gather import gather_cuda, gather_ref

    ids = ids.reshape(-1).contiguous()

    def make():
        V, d = table.shape
        n = ids.shape[0]
        got, want = gather_cuda(table, ids), gather_ref(table, ids)
        check(torch.equal(got, want), f"gather V={V} d={d} n={n}: differs from plain")
        call = lambda: gather_cuda(table, ids)
        check(launches_per_call("gather", call) == 1, f"gather V={V} d={d} n={n}: not one "
              "launch a call")
        valid = ids[ids != INVALID]
        rows_read = int(torch.unique(valid).numel())
        clamped = ids.clamp(0, V - 1)
        err = float_err(got, want)
        del got, want
        # 5 calls a graph at d = 64; fewer for a wider table (3.2 GB an output at d = 768)
        calls = max(1, 5 * 64 // d)
        was = GATHER_WAS_MS.get(paths[0]) if paths else None
        return dict(
            shape=f"V={V} d={d} n={n} ({int(valid.numel())} valid)",
            bytes=4 * n + 4 * d * rows_read + 4 * n * d, ops=n, max_abs_err=err,
            paths=paths, per=per,
            fill_ms=graph_ms(lambda: torch.zeros((n, d), device=table.device), calls),
            **({"extra_was": f"{was} ms (thread per float4)"} if was else {}),
            **timings(call, lambda: gather_ref(table, ids),
                      lambda: torch.index_select(table, 0, clamped), calls=calls),
        )

    return shared_row("gather", (table, ids), paths, per, make)


def phase1_paths(engine, rgcn_engine, sage_engine, tds, tc) -> dict:
    """``frontier_gather``, ``unique_compact`` and ``gather`` at the shapes
    of phases 6 and 7, as phase 1 holds the GCN's: step 0's plan of the
    R-GCN (its gather at d = 768) and of GraphSAGE with NS, one
    cooperative ``plan_at(0)`` with ``rw`` (no neighbor table) and with
    ``full``, and the work curves' NS plan at the largest batch (first
    trial).  A row on the same inputs as an earlier row names the new path
    there instead."""
    import numpy as np
    import torch
    from repro_torch.core.samplers import make_sampler
    from repro_torch.core.theory import sample_work_curve
    from repro_torch.engine import MinibatchEngine

    out = {"frontier_gather": [], "unique_compact": [], "gather": []}
    P = tc.num_pes
    for path, eng, tag in (("train_rgcn", rgcn_engine, "rgcn "), ("train_sage", sage_engine, "ns ")):
        plan = eng.plan_at(0)
        plan_rows(out, eng, plan, [path], f"{P}/step", tag)
        add_row(out, "gather", gather_row(eng.store.features, plan.input_ids, [path], "1/step"))
    # off the paths: every id valid, drawn from the R-GCN's table (the
    # valid-row branch, which the paths' 98% padding barely runs)
    table = rgcn_engine.store.features
    ids = np.random.default_rng(SEED + 4).integers(0, table.shape[0], GATHER_ALL_VALID)
    add_row(out, "gather", gather_row(table, torch.from_numpy(ids.astype(np.int32)).cuda(),
                                      [], "all ids valid"))
    for sampler in ("rw", "full"):
        eng = MinibatchEngine.from_config(
            tds.graph, dataclasses.replace(tc, sampler=sampler).engine_config(3), dataset=tds,
            device="cuda")
        plan_rows(out, eng, eng.plan_at(0), [f"plan_{sampler}"], f"{P}/plan", f"{sampler} ",
                  frontiers=sampler != "rw")
    g = engine.graph
    curve = sample_work_curve(g, make_sampler("ns", fanout=10, backend="fused"), CURVE_BATCHES,
                              num_layers=3, trials=2)
    mb = next(mb for bs, _, mb in curve if bs == CURVE_BATCHES[-1])
    for l, layer in enumerate(mb.layers):
        seeds = layer.seeds.contiguous()
        add_row(out, "frontier_gather", shared_row(
            "frontier_gather", (g.indptr, g.indices, seeds), ["curves"], "1/plan layer",
            lambda: frontier_row(g, seeds, ["curves"], "1/plan layer",
                                 f"ns curve batch {CURVE_BATCHES[-1]} layer {l}")))
    report_bounds(out)
    return out


def phase1_dependent(dep_engines: dict, P: int) -> dict:
    """The kernels of phase 8's path at its shapes: step 0's plan of each
    mode (``dep_engines``, κ = 16, cache on; the cooperative plan is the
    R-GCN's, so its rows only gain the path's name) and ``tag_probe`` at
    each mode's probe of step 1."""
    out = {}
    for mode, eng in dep_engines.items():
        plan = eng.plan_at(0)
        if mode == "cooperative":
            plan_rows(out, eng, plan, ["dependent"], f"{P}/step", "dependent ")
        else:
            independent_rows(out, eng, plan, ["dependent"], f"{P}/step", "independent ")
        tags, sets, ids = recorded_probe(eng, plan)
        # the tiered store's probe and the ClockCache's, which holds the same state
        add_row(out, "tag_probe", probe_row(tags, sets, ids, ["dependent"], "2/step",
                                            f"dependent {mode} step 1"))
    report_bounds(out)
    return out


def independent_rows(out: dict, engine, plan, paths: list, per: str, tag: str) -> None:
    """Rows of ``frontier_gather`` at PE 0's frontier of every layer of a
    stacked independent ``plan`` and of ``unique_compact`` at PE 0's
    dedups in ``build_minibatch`` (the seeds; per hop, the frontier with
    its sampled neighbors, rebuilt from the plan), added to ``out``."""
    import torch
    from repro_torch.core.graph import INVALID

    g, caps, L = engine.graph, engine.caps, len(plan.layers)
    dedups = [(torch.from_numpy(engine.seed_batch(0)[0]).to(g.indptr.device), caps[0], "seeds")]
    for l, layer in enumerate(plan.layers):
        seeds = layer.seeds[0].contiguous()
        add_row(out, "frontier_gather", shared_row(
            "frontier_gather", (g.indptr, g.indices, seeds), paths, per,
            lambda: frontier_row(g, seeds, paths, per, f"{tag}layer {l}")))
        nxt = plan.layers[l + 1].seeds[0] if l + 1 < L else plan.input_ids[0]
        nbr = torch.where(layer.mask[0], nxt[layer.nbr_idx[0].clamp(min=0).long()], INVALID)
        dedups.append((torch.cat([layer.seeds[0], nbr.reshape(-1)]), caps[l + 1], f"hop {l}"))
    for ids, cap, label in dedups:
        ids = ids.contiguous()
        add_row(out, "unique_compact", shared_row(
            "unique_compact", (ids, cap), paths, per,
            lambda: dedup_row(ids, cap, paths, per, f"{tag}{label}")))


def recorded_probe(engine, plan0) -> tuple:
    """The ``tag_probe`` inputs ``(tags, sets, ids)`` that the engine's
    tiered store passes at step 1, after step 0's gather: recorded by a
    wrapper around the probe for one eager run of the store's access
    program (its replays call no Python) on a copy of its state."""
    import repro_torch.store.clock as clock

    engine.gather_features(plan0)
    tiered, ids = engine.tiered, engine.plan_at(1).input_ids
    state = type(tiered.state)(*(t.clone() for t in tiered.state))
    seen, probe = [], clock.tag_probe

    def record(tags, sets, ids):
        seen.append((tags.clone(), sets.clone(), ids.clone()))
        return probe(tags, sets, ids)

    clock.tag_probe = record
    try:
        tiered.access_program.fn(state, ids)
    finally:
        clock.tag_probe = probe
    check(len(seen) == 1, f"{len(seen)} tag_probe calls in one tiered gather, want 1")
    return seen[0]


def phase1_mean(rgcn_engine, sage_engine) -> dict:
    """``spmm``'s mean mode, forward and backward, against its plain
    versions at the shapes of the R-GCN and GraphSAGE paths: PE 0's index
    table of every layer of step 0's plan of each engine.  R-GCN: relation
    0's slots (``mask & (etypes == 0)``, one of its 4 calls a layer) at d =
    1,024, 1,024 and 768 (plan layers 0, 1, 2), the backward on the path at
    layers 0 and 1; GraphSAGE: plan layer 2 (d = 64), its backward off the
    path, as the GCN's."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    out = {"spmm": [], "spmm_backward": []}
    plan, caps, cfg = rgcn_engine.plan_at(0), rgcn_engine.caps, RGCN_CFG
    P, L = plan.seed_ids.shape[0], len(plan.layers)
    per = f"{P * cfg['num_relations']}/step"  # one call a relation per PE
    for l, layer in enumerate(plan.layers):
        d = cfg["in_dim"] if l == L - 1 else cfg["hidden_dim"]
        mask = layer.mask[0] & (layer.etypes[0] == 0)
        f, b = spmm_rows(layer.nbr_idx[0], mask, caps.tilde_caps[l], d, rng,
                         paths=["train_rgcn"], per=per, backward=l < L - 1,
                         label=f"rgcn layer {l} relation 0", mean=True)
        out["spmm"].append(f)
        if b is not None:
            out["spmm_backward"].append(b)
    plan, caps = sage_engine.plan_at(0), sage_engine.caps
    l = len(plan.layers) - 1
    f, b = spmm_rows(plan.layers[l].nbr_idx[0], plan.layers[l].mask[0], caps.tilde_caps[l],
                     64, rng, paths=["train_sage"], per=f"{P}/step",
                     backward_on_path=False, label=f"sage layer {l}", mean=True)
    out["spmm"].append(f)
    out["spmm_backward"].append(b)
    report_bounds(out)
    return out


def dedup_row(ids, cap: int, paths: list, per: str, label: str) -> dict:
    """``unique_compact`` on the sorted ``ids`` against its plain version,
    equal bit for bit with the inverse in sorted order (an identity
    permutation) and in input order (the sort's); timed as the path runs
    it, with the sort's permutation.  Bytes: the ids and the permutation
    read once, the inverse and ``cap`` unique ids written once; per id a
    compare, a scan add and two tests."""
    import torch
    from repro_torch.kernels.unique_compact import unique_compact_cuda, unique_compact_sorted_ref

    s, order = torch.sort(ids)
    m = s.shape[0]
    mae = 0
    for o in (torch.arange(m, device=s.device), order):
        inv, uniq = unique_compact_cuda(s, cap, o)
        inv_r, uniq_r = unique_compact_sorted_ref(s, cap, o)
        check(torch.equal(inv, inv_r) and torch.equal(uniq, uniq_r),
              f"unique_compact m={m} cap={cap} ({label}, "
              f"order={'sort' if o is order else 'identity'}): differs from plain")
        mae = max(mae, max_abs_err(inv, inv_r), max_abs_err(uniq, uniq_r))
    calls = 5 if m > 100_000 else 20
    row = dict(
        shape=f"{label}: m={m} cap={cap} unique={int((uniq_r != 0x7fffffff).sum())}",
        bytes=4 * m + 8 * m + 4 * m + 4 * cap, ops=4 * m, max_abs_err=mae, paths=paths, per=per,
        **timings(lambda: unique_compact_cuda(s, cap, order),
                  lambda: unique_compact_sorted_ref(s, cap, order),
                  lambda: torch.unique(s, sorted=True, return_inverse=True), calls=calls,
                  library_syncs=True),
    )
    row["extra_split"] = kernel_split(
        profiled_kernels(lambda: unique_compact_cuda(s, cap, order)))
    return row


def dedup_whole(cases) -> None:
    """The whole dedup as the path runs it -- ``unique_with_inverse``: the
    sort, then the kernel -- beside ``torch.unique(return_inverse=True)`` on
    the same unsorted ids and ``torch.sort`` alone (profiled device ms, and
    per-call event ms)."""
    import torch
    from repro_torch.kernels.unique_compact import unique_with_inverse, unique_with_inverse_ref

    for ids, cap, label in cases:
        uniq, inv = unique_with_inverse(ids, cap)
        uniq_r, inv_r = unique_with_inverse_ref(ids, cap)
        check(torch.equal(uniq, uniq_r) and torch.equal(inv, inv_r),
              f"unique_with_inverse ({label}) differs from plain")
        fns = {"unique_with_inverse": lambda: unique_with_inverse(ids, cap),
               "torch.sort": lambda: torch.sort(ids),
               "torch.unique(return_inverse)":
                   lambda: torch.unique(ids, sorted=True, return_inverse=True)}
        parts = "; ".join(f"{k} device {device_ms(f)} event {event_ms(f):.5f}"
                          for k, f in fns.items())
        print(f"phase1 dedup ({label}: m={ids.numel()} cap={cap}), ms by profiler sum "
              f"(torch.unique syncs): {parts}")


def seg_softmax_rows(mask, h: int, rng):
    """``seg_softmax`` and its backward against the plain versions on the
    card, on one layer's ``(n, w)`` mask with ``h`` heads (logits and
    gradients from ``rng``), within ``SEG_ATOL`` / ``SEG_BWD_ATOL * max|g|``
    with masked slots exactly 0; rows with timings and bounds.  Bytes: the
    mask, the logits (forward) or alpha and g (backward) of the valid
    slots, and the whole output."""
    import numpy as np
    import torch
    from repro_torch.kernels.seg_softmax import (
        seg_softmax_backward_cuda,
        seg_softmax_backward_ref,
        seg_softmax_cuda,
        seg_softmax_ref,
    )

    n, w = mask.shape
    e = torch.from_numpy((3 * rng.standard_normal((n, w, h))).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((n, w, h)).astype(np.float32)).cuda()
    valid = mask[..., None].expand(n, w, h)
    nnz = int(mask.sum())
    shape = f"n={n} w={w} h={h} valid slots={nnz}"
    got, want = seg_softmax_cuda(e, mask), seg_softmax_ref(e, mask)
    err = float_err(got, want)
    check(err <= SEG_ATOL, f"seg_softmax {shape}: max abs err {err} > {SEG_ATOL}")
    check(not bool(got[~valid].any()), f"seg_softmax {shape}: masked slots not 0")
    pre = torch.where(valid, e, -1e9)
    fwd = dict(
        shape=shape, bytes=n * w + 4 * h * nnz + 4 * n * w * h, ops=5 * h * nnz + n * h,
        max_abs_err=err,
        **timings(lambda: seg_softmax_cuda(e, mask), lambda: seg_softmax_ref(e, mask),
                  lambda: torch.softmax(pre, dim=1), calls=5),
    )
    alpha = want
    got = seg_softmax_backward_cuda(alpha, g, mask)
    want = seg_softmax_backward_ref(alpha, g, mask)
    err = float_err(got, want)
    atol = SEG_BWD_ATOL * float(g.abs().max())
    check(err <= atol, f"seg_softmax_backward {shape}: max abs err {err} > {atol}")
    check(not bool(got[~valid].any()), f"seg_softmax_backward {shape}: masked slots not 0")
    with torch.cuda.stream(capture_stream()):  # the backward runs where this forward ran
        leaf = pre.clone().requires_grad_()
        y = torch.softmax(leaf, dim=1)
    torch.cuda.current_stream().wait_stream(capture_stream())
    bwd = dict(
        shape=shape, bytes=n * w + 8 * h * nnz + 4 * n * w * h, ops=4 * h * nnz,
        max_abs_err=err,
        **timings(lambda: seg_softmax_backward_cuda(alpha, g, mask),
                  lambda: seg_softmax_backward_ref(alpha, g, mask),
                  lambda: torch.autograd.grad(y, leaf, g, retain_graph=True), calls=5),
    )
    return fwd, bwd


def expand_indptr_row(mask) -> dict:
    """``expand_indptr`` against its plain version, equal bit for bit, on
    the indptr of one layer's ``(n, w)`` mask with ``n * w`` edge slots
    (``layer_to_coo``'s capacity).  Bytes: indptr read once, the rows
    written once; operations: a compare per slot and a binary search per
    slot that holds an edge."""
    import math

    import torch
    from repro_torch.kernels.expand_indptr import expand_indptr_cuda, expand_indptr_ref

    n, w = mask.shape
    counts = mask.sum(dim=1).to(torch.int32)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0).to(torch.int32)])
    E, total = n * w, int(indptr[-1])
    got, want = expand_indptr_cuda(indptr, E), expand_indptr_ref(indptr, E)
    check(torch.equal(got, want), f"expand_indptr R={n} E={E}: differs from plain")
    slots = torch.arange(E, dtype=torch.int32, device=indptr.device)
    return dict(
        shape=f"R={n} E={E} edges={total}", bytes=4 * (n + 1) + 4 * E,
        ops=E + total * math.ceil(math.log2(n + 1)), max_abs_err=max_abs_err(got, want),
        **timings(lambda: expand_indptr_cuda(indptr, E), lambda: expand_indptr_ref(indptr, E),
                  lambda: torch.searchsorted(indptr, slots, right=True), calls=5),
    )


def float_err(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def spmm_rows(idx, mask, S: int, d: int, rng, paths: list, per: str, backward: bool = True,
              backward_on_path: bool = True, label: str = "", mean: bool = False):
    """``spmm`` (and its backward) against the plain versions on one
    layer's index tables ``(n, w)`` over ``S`` source rows of width ``d``
    (values from ``rng``), equal bit for bit in both modes, and the backward
    equal to itself over two calls; rows with timings and bounds of the sum
    mode, or of the mean mode if ``mean`` (then the library yardstick's
    per-slot weights are ``1 / max(deg, 1)``).  Bytes count what the
    function needs, in either mode: the mask, the index of each masked
    slot, each source row a masked slot reads (forward) or each gradient
    row that has a masked slot (backward), and the output written once.
    ``paths`` run the forward at this shape; the backward too if
    ``backward_on_path``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.spmm import (
        spmm_backward_cuda,
        spmm_backward_ref,
        spmm_cuda,
        spmm_ref,
    )

    idx, mask = idx.contiguous(), mask.contiguous()
    src = torch.from_numpy(rng.standard_normal((S, d)).astype(np.float32)).cuda()
    n, w = idx.shape
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    nnz = int(mask.sum())
    keys = idx[mask].clamp(0, S - 1).long()
    touched = int(torch.unique(keys).numel())
    longest = int(torch.bincount(keys).max()) if nnz else 0
    rows_hit = int(mask.any(dim=1).sum())
    shape = (f"{label + ': ' if label else ''}S={S} n={n} w={w} d={d} nnz={nnz}"
             + (" mean" if mean else ""))
    err = 0.0
    for mode in (False, True):  # both modes checked, ``mean``'s timed
        got, want = spmm_cuda(src, idx, mask, mode), spmm_ref(src, idx, mask, mode)
        check(torch.equal(got, want), f"spmm {shape} mean={mode}: differs from plain")
        err = max(err, float_err(got, want))
    bag_idx, bag_w = idx.clamp(0, S - 1), mask.float()  # embedding_bag's inputs
    if mean:
        bag_w = bag_w / bag_w.sum(dim=1, keepdim=True).clamp(min=1)
    fwd = dict(
        shape=shape, bytes=n * w + 4 * nnz + 4 * d * touched + 4 * n * d, ops=nnz * d,
        max_abs_err=err, paths=paths, per=per, extra_rows_hit=rows_hit,
        **timings(lambda: spmm_cuda(src, idx, mask, mean),
                  lambda: spmm_ref(src, idx, mask, mean),
                  lambda: F.embedding_bag(bag_idx, src, mode="sum", per_sample_weights=bag_w),
                  calls=5),
    )
    if not backward:
        return fwd, None
    err = 0.0
    for mode in (False, True):
        got = spmm_backward_cuda(g, idx, mask, S, mode)
        want = spmm_backward_ref(g, idx, mask, S, mode)
        check(torch.equal(got, want), f"spmm_backward {shape} mean={mode}: differs from plain")
        check(torch.equal(spmm_backward_cuda(g, idx, mask, S, mode), got),
              f"spmm_backward {shape} mean={mode}: two calls differ")
        err = max(err, float_err(got, want))
    with torch.cuda.stream(capture_stream()):  # the backward runs where this forward ran
        leaf = src.clone().requires_grad_()
        bag = F.embedding_bag(bag_idx, leaf, mode="sum", per_sample_weights=bag_w)
    torch.cuda.current_stream().wait_stream(capture_stream())
    bwd = dict(
        shape=shape, bytes=n * w + 4 * nnz + 4 * d * rows_hit + 4 * S * d, ops=nnz * d,
        max_abs_err=err, paths=paths if backward_on_path else [], per=per,
        extra_longest_run=longest,
        extra_split=kernel_split(profiled_kernels(
            lambda: spmm_backward_cuda(g, idx, mask, S, mean))),
        **timings(lambda: spmm_backward_cuda(g, idx, mask, S, mean),
                  lambda: spmm_backward_ref(g, idx, mask, S, mean),
                  lambda: torch.autograd.grad(bag, leaf, g, retain_graph=True),
                  calls=5, plain_syncs=True),
    )
    return fwd, bwd


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------
def phase2(ds, gnn_cfg, serve_cfg, trace) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.gnn import init_gnn
    from repro_torch.serve import GNNServer, poisson_trace

    server = GNNServer(ds.graph, ds.features, gnn_cfg,
                       init_gnn(gnn_cfg, seed=SEED, device="cuda"), serve_cfg, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    rep = server.serve_trace(trace)
    gpu_s = time.perf_counter() - t0
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    print(f"phase2 card serve: {len(rep.batches)} batches in {gpu_s:.2f} s; "
          f"launches {launches}")
    for k in PATH_KERNELS["serve"]:
        check(launches[k] > 0, f"kernel {k} was not launched on the serving path")
    for guard in (server._plan_guard, server._forward_guard):
        served = sorted({b.bucket for b in rep.batches})
        check(guard.capture and all(guard.program(b) is not None for b in served),
              f"{guard.name}: a served bucket has no captured program")
        check(all(n == 1 for n in guard.compiles.values()),
              f"{guard.name}: compiles {guard.compiles}, want one a bucket")
        print(f"phase2 {guard.name}: compiles {guard.compiles}; per bucket capture ms, pool "
              "bytes grown and launches a replay: " + "; ".join(
                  f"{b}: {r['capture_ms']:.1f} ms, {r['pool_bytes']} B, {r['launches']}"
                  for b, r in sorted(guard.report().items())))

    served = sorted({b.bucket for b in rep.batches})
    for prog in (server.tiered.access_program, server.tiered.assemble_program):
        check(prog.capture and set(served) <= set(prog.compiles)
              and all(n == 1 for n in prog.compiles.values())
              and all(n == 1 for n in prog.captures.values()),
              f"{prog.name}: compiles {prog.compiles}, captures {prog.captures}, want one "
              "capture a served bucket")
        print(f"phase2 {prog.name} (the tiered store's program): compiles {prog.compiles}; per "
              "bucket capture ms, pool bytes grown and launches a replay: " + "; ".join(
                  f"{b}: {r['capture_ms']:.1f} ms, {r['pool_bytes']} B, {r['launches']}"
                  for b, r in sorted(prog.report().items())))

    cpu = GNNServer(ds.graph, ds.features, gnn_cfg, init_gnn(gnn_cfg, seed=SEED, device="cpu"),
                    serve_cfg, device="cpu")
    t0 = time.perf_counter()
    ref = cpu.serve_trace(trace)
    print(f"phase2 cpu serve (plain path): {time.perf_counter() - t0:.2f} s")
    acct = lambda r: (r.fetched_rows, r.requested_rows, r.cache_hits)
    print(f"phase2 accounting card {acct(rep)} cpu {acct(ref)}")
    check(acct(rep) == acct(ref), "fetched/requested/hits differ from the CPU run")
    check(len(rep.batches) == len(ref.batches), "batch count differs from the CPU run")
    fields = ("bucket", "num_requests", "num_unique", "edges", "fetched_rows")
    for a, b in zip(rep.batches, ref.batches):
        va, vb = [getattr(a, f) for f in fields], [getattr(b, f) for f in fields]
        check(va == vb, f"batch {a.index}: card {va} != cpu {vb} ({fields})")
    plan_entries, plan_diff, times = compare_plans(server, cpu, rep)
    print(f"phase2 plan leaves, the captured serve.plan replayed against the card's eager "
          f"build and the CPU's: {plan_entries} entries over {len(rep.batches)} batches, "
          f"{plan_diff} differ; plan ms a batch by bucket (replayed / eager, host clock to a "
          "sync): " + "; ".join(f"{b}: {sum(r) / len(r):.3f} / {sum(e) / len(e):.3f} over "
                                f"{len(r)}" for b, (r, e) in sorted(times.items())))
    check(plan_diff == 0, f"{plan_diff} plan entries differ between replay, eager and CPU")
    spmm_row = serve_spmm_row(server, rep, gnn_cfg)
    by_rid = {s.request.rid: s.pred for s in ref.served}
    preds = np.stack([s.pred for s in rep.served])
    check(preds.shape == (len(trace), gnn_cfg.num_classes), f"logits shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite logits")
    err = max(float(np.abs(s.pred - by_rid[s.request.rid]).max()) for s in rep.served)
    print(f"phase2 logits card vs cpu: max abs diff {err:.3e} (atol {ATOL})")
    check(err <= ATOL, f"logits differ from the CPU run by {err}")

    coalesced = {s.request.rid: s.pred for s in rep.served}
    server.reset()
    single = server.serve_independent(trace[:32])
    err1 = max(float(np.abs(s.pred - coalesced[s.request.rid]).max()) for s in single.served)
    print(f"phase2 per-request vs coalesced (32 requests, card): max abs diff {err1:.3e}")
    check(err1 <= ATOL, f"per-request logits differ from coalesced by {err1}")

    measured = GNNServer(
        ds.graph, ds.features, gnn_cfg, init_gnn(gnn_cfg, seed=SEED, device="cuda"),
        dataclasses.replace(serve_cfg, service_model="measured"), device="cuda",
    )
    measured.serve_trace(trace[:64])  # warm-up: allocator, cuBLAS handles
    for bucket in measured.ladder.buckets:  # and every bucket's captured programs
        measured.hot_path(torch.from_numpy(ds.user_ids[:bucket].astype(np.int32)).cuda())
    measured.reset()
    report_measured("overload: 500 requests at 4000 rps", measured, trace)
    measured.reset()
    steady = poisson_trace(STEADY_REQUESTS, STEADY_RPS, ds.user_ids, seed=SEED + 1)
    report_measured(f"steady: {STEADY_REQUESTS} requests at {STEADY_RPS:.0f} rps",
                    measured, steady)
    profile_serve(measured, trace)
    return {"launches": launches, "logit_err": err, "spmm": spmm_row}


def serve_spmm_row(server, report, gnn_cfg) -> dict:
    """``spmm`` against its plain version on the serving path's shapes: the
    largest layer (by slots) of the plan of the largest served batch."""
    import numpy as np

    groups: dict[int, list] = {}
    for s in report.served:
        groups.setdefault(s.batch_index, []).append(s.request)
    reqs = max(groups.values(), key=len)
    plan = server.coalescer.build_plan(server.coalescer.coalesce(reqs, 0.0))
    L = len(plan.layers)
    l = max(range(L), key=lambda i: plan.layers[i].nbr_idx.numel())
    S = (plan.layers[l + 1].seeds if l + 1 < L else plan.input_ids).shape[0]
    row, _ = spmm_rows(plan.layers[l].nbr_idx, plan.layers[l].mask, S, gnn_cfg.dims(l)[0],
                       np.random.default_rng(SEED + 3), ["serve"], "1/batch", backward=False)
    row["shape"] = f"serving plan of {len(reqs)} requests, layer {l}: {row['shape']}"
    report_bounds({"spmm": [row]})
    return row


def compare_plans(card, cpu, report) -> tuple[int, int, dict]:
    """Every served batch's plan three ways: the card server's captured
    ``serve.plan`` (a replay), the card's eager build of the same seeds and
    the CPU's; counts the integer plan entries (seeds, self_idx, nbr_idx,
    mask of every layer, and the input frontier) and those that differ in
    either comparison, and times replay and eager build by bucket."""
    import torch

    groups: dict[int, list] = {}
    for s in report.served:
        groups.setdefault(s.batch_index, []).append(s.request)
    entries = differ = 0
    times: dict[int, tuple[list, list]] = {}
    leaves = lambda p: [t for layer in p.layers
                        for t in (layer.seeds, layer.self_idx, layer.nbr_idx, layer.mask)
                        ] + [p.input_ids]
    for _, reqs in sorted(groups.items()):
        batch = card.coalescer.coalesce(reqs, 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replayed = card._plan(batch.seeds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eager = card.coalescer.build_plan(batch)
        torch.cuda.synchronize()
        r, e = times.setdefault(batch.bucket, ([], []))
        r.append(1e3 * (t1 - t0))
        e.append(1e3 * (time.perf_counter() - t1))
        want = cpu.coalescer.build_plan(cpu.coalescer.coalesce(reqs, 0.0))
        for a, b, c in zip(leaves(replayed), leaves(eager), leaves(want)):
            entries += a.numel()
            differ += int(((a != b).cpu() | (a.cpu() != c)).sum())
    return entries, differ, times


def report_measured(label, server, trace) -> None:
    """Serve ``trace`` on the measured clock and print its latencies, wall
    ms per batch and the server's own stage split of that wall time."""
    import numpy as np

    rep = server.serve_trace(trace)
    summary = rep.summary()
    col = lambda f: np.asarray([getattr(b, f) for b in rep.batches])
    walls = col("wall_ms")
    stages = ", ".join(f"{f[:-3]} {float(col(f).mean()):.3f}"
                       for f in ("plan_ms", "gather_ms", "forward_ms"))
    lat = rep.latencies_ms()[np.argsort([s.request.t_arrival for s in rep.served])]
    half = len(lat) // 2
    print(f"phase2 measured, {label}: p50 {summary['p50_ms']} ms p95 "
          f"{summary['p95_ms']} ms p99 {summary['p99_ms']} ms; p50 of the first / "
          f"second half of arrivals {float(np.median(lat[:half])):.3f} / "
          f"{float(np.median(lat[half:])):.3f} ms; wall per batch median "
          f"{float(np.median(walls)):.3f} ms mean {float(walls.mean()):.3f} ms over "
          f"{len(walls)} batches (mean batch {summary['mean_batch']} requests); "
          f"stage means ms per batch: {stages} (sum {float(walls.mean()):.3f}); "
          f"cache hit rate {server.tiered.hit_rate:.4f}; throughput "
          f"{summary['throughput_rps']} rps")


def profile_serve(server, trace) -> None:
    """Where the time goes in one served trace: device busy share of the
    wall clock, the kernels that take it (torch.profiler, CUPTI), and the
    host ms of the plan and the gather (with the profiler's own
    overhead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    server.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rep = server.serve_trace(trace)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    stats = cuda_kernel_us(prof)
    busy_ms = sum(d for d, _, _ in stats) / 1e3
    nb = len(rep.batches)
    plan_ms = sum(b.plan_ms for b in rep.batches) / nb
    gather_ms = sum(b.gather_ms for b in rep.batches) / nb
    print(f"phase2 profile (profiler on): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.4f}; host ms per "
          f"batch: plan {plan_ms:.3f}; gather {gather_ms:.3f}")
    for dev_us, count, key in stats[:12]:
        print(f"  device {dev_us / 1e3:9.3f} ms  calls {count:6d}  {key[:90]}")
    groups = []
    for name, parts in SERVE_PROFILE_GROUPS.items():
        hit = [(us, c) for us, c, key in stats if any(p in key for p in parts)]
        groups.append(f"{name} {sum(us for us, _ in hit) / 1e3 / nb:.5f} "
                      f"({sum(c for _, c in hit) / nb:g} kernels)")
    print(f"phase2 profile device ms per batch over {nb} batches: " + ", ".join(groups))


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------
def int_leaves(plan) -> dict:
    """Every integer (and bool) leaf of a plan (cooperative or stacked
    independent), by name."""
    out = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in ("seeds", "self_idx", "nbr_idx", "mask", "etypes",
                     "slot_to_tilde", "req_idx", "tilde_ids"):
            if getattr(layer, name, None) is not None:
                out[f"{name}{l}"] = getattr(layer, name)
    return out


def host_leaves(plan) -> dict:
    """:func:`int_leaves` as host numpy arrays."""
    return {k: v.cpu().numpy() for k, v in int_leaves(plan).items()}


def train_eager(tds, gnn_cfg, tc, model, device, on_step):
    """``train_gnn``'s steps (``tc.num_steps``, sim or shard executor)
    through the body of its step program run eagerly (``program.fn``: no
    graph and no recorder active, so no markers or counters), ``model``
    trained in place: what a captured run is held against on the card.
    ``on_step(step, plan)`` as ``train_gnn``'s; returns a ``TrainResult``
    with the losses and each step's wall ms."""
    import numpy as np
    import torch
    from repro_torch.engine import MinibatchEngine
    from repro_torch.train import TrainResult, adam_init, step_program

    engine = MinibatchEngine.from_config(tds.graph, tc.engine_config(gnn_cfg.num_layers),
                                         dataset=tds, device=device)
    model = model.to(engine.device)
    labels = torch.as_tensor(np.asarray(tds.labels)).to(engine.device)
    program = step_program(engine, gnn_cfg, model, adam_init(list(model.parameters())),
                           labels, tc.lr, with_plan=True)
    result = TrainResult(model=model)
    for step in range(tc.num_steps):
        t0 = time.perf_counter()
        loss, plan = program.fn(engine.step_state(step))
        result.losses.append(float(loss))
        result.step_ms.append(1e3 * (time.perf_counter() - t0))
        on_step(step, plan)
    return result


def phase_train(tag: str, path: str, tds, gnn_cfg, tc, check_seeds: bool = False,
                cpu_steps: int | None = None) -> dict:
    """Cooperative training of ``gnn_cfg`` on the card and on the CPU, each
    from ``train_gnn``'s own weights for ``tc.seed`` (the JAX package's);
    ``path`` names the kernels it must launch.  The GCN, GraphSAGE and
    R-GCN must launch the ``spmm`` forward once a layer per PE and relation
    each step, the backward once a layer but the last.  The CPU runs the
    card's first ``cpu_steps`` steps (all by default): their plans and
    losses must agree, the initial weights be equal and the step-0
    gradients agree (:func:`check_gradients`); where the CPU ran every
    step, the final weights within ``TRAIN_ATOL`` too.  Returns the
    launches, the loss gap, the walls, the card's step-0 plan, every card
    step's integer plan leaves on the host, the card's losses and its
    initial weights and step-0 gradients."""
    import numpy as np
    import torch
    from repro_torch.engine import MinibatchEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.gnn import init_gnn
    from repro_torch.train import train_gnn

    L = gnn_cfg.num_layers
    cpu_steps = cpu_steps or tc.num_steps
    if check_seeds:
        for step in range(tc.num_steps):
            a, b = (MinibatchEngine.from_config(tds.graph, tc.engine_config(L), dataset=tds,
                                                device=dev).seed_batch(step)
                    for dev in ("cuda", "cpu"))
            check(np.array_equal(a, b), f"seed_batch differs from the CPU at step {step}")
        print(f"{tag} seed_batch card vs cpu: equal at steps 0..{tc.num_steps - 1}, "
              f"shape {a.shape}")

    plans, first, per_step = {"cuda": [], "eager": [], "cpu": []}, {}, []

    def run(dev: str, steps: int, eager: bool = False):
        """``steps`` steps on ``dev`` from ``init_gnn(cfg, tc.seed)`` (the
        weights ``train_gnn`` draws by default); keeps each step's plan, the
        initial weights and the step-0 gradient of every parameter (a hook
        on each, removed after step 0).  On the card the program's run
        reads its spans after each step (``stage_times``); ``eager`` runs
        its body eagerly instead (:func:`train_eager`)."""
        key = "eager" if eager else dev
        model = init_gnn(gnn_cfg, seed=tc.seed, device=dev)
        named = list(model.named_parameters())
        grads = {}

        def keep(i, g):
            if i not in grads:
                grads[i] = g.detach().clone()

        hooks = [p.register_hook(functools.partial(keep, i)) for i, (_, p) in enumerate(named)]
        first[key] = {"names": [n for n, _ in named],
                      "init": [p.detach().cpu().numpy().copy() for _, p in named]}

        def on_step(step, plan):
            plans[key].append(plan)
            if key == "cuda":
                per_step.append({k: LAUNCHES.get(k, 0) for k in KERNELS})
            if step == 0:
                for h in hooks:
                    h.remove()
                first[key]["grad"] = [grads[i].cpu().numpy() for i in range(len(named))]

        run_tc = dataclasses.replace(tc, num_steps=steps)
        if eager:
            return train_eager(tds, gnn_cfg, run_tc, model, dev, on_step)
        return train_gnn(tds, gnn_cfg, run_tc, model=model, device=dev,
                         stage_times=dev == "cuda", on_step=on_step)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = run("cuda", tc.num_steps)
    card_s = time.perf_counter() - t0
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    print(f"{tag} card train ({gnn_cfg.model}), the captured train step: {tc.num_steps} steps "
          f"in {card_s:.2f} s (engine set-up and the capture included); launches {launches}")
    for k in PATH_KERNELS[path]:
        check(launches[k] > 0, f"kernel {k} was not launched on the {path} path")
    calls = {"gcn": 1, "sage": 1, "rgcn": gnn_cfg.num_relations}.get(gnn_cfg.model, 0)
    want = {"spmm": tc.num_pes * L * calls, "spmm_backward": tc.num_pes * (L - 1) * calls}
    prev = {k: 0 for k in KERNELS}
    for step, (ms, cum) in enumerate(zip(card.step_ms, per_step)):
        per = {k: cum[k] - prev[k] for k in KERNELS if cum[k] - prev[k]}
        prev = cum
        print(f"{tag} card step {step}: wall {ms:.3f} ms to the loss's read"
              + (" (eager warm-up + capture)" if step == 0 else " (a replay)")
              + f"; loss {card.losses[step]:.6f}; launches {per}")
        if calls:
            got = {k: per.get(k, 0) for k in want}
            check(got == want, f"step {step}: spmm launches {got}, want {want}")
    comp = card.compiled
    key = tc.local_batch
    check(comp and comp["compiles"] == {key: 1} and comp["captures"] == {key: 1},
          f"{tag}: the train step was not captured once: {comp}")
    rec = comp["report"][key]
    print(f"{tag} train_step program: capture {rec['capture_ms']:.1f} ms, pool grown "
          f"{rec['pool_bytes']} B ({rec['pool_bytes'] / 2**30:.2f} GiB), launches a replay "
          f"{rec['launches']}; warm steps ms "
          + ", ".join(f"{x:.3f}" for x in card.step_ms[1:])
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    for step, st in enumerate(card.stage_ms):
        print(f"{tag} card step {step} by span: {sum(st.values()):.3f} ms = "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))

    # the step's body run eagerly on the card, and the captured step held
    # against it (plans bit for bit, losses and weights within the tolerances)
    torch.cuda.reset_peak_memory_stats()
    eager = run("cuda", tc.num_steps, eager=True)
    print(f"{tag} card eager steps ms "
          + ", ".join(f"{x:.3f}" for x in eager.step_ms) + "; peak device memory "
          + f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    differ = sum(int((la[n].cpu() != lb[n].cpu()).sum())
                 for a, b in zip(plans["cuda"], plans["eager"])
                 for la, lb in [(int_leaves(a), int_leaves(b))] for n in la)
    ce_rel = float(np.max(np.abs(np.asarray(card.losses) - np.asarray(eager.losses))
                          / np.abs(np.asarray(eager.losses))))
    ce_w = max(float(np.abs(a[k] - b[k]).max())
               for a, b in zip(card.params["layers"], eager.params["layers"]) for k in a)
    print(f"{tag} captured vs eager step on the card, {tc.num_steps} steps: plan entries that "
          f"differ {differ}; losses max rel diff {ce_rel:.3e} (rtol {TRAIN_RTOL}); final "
          f"weights max abs diff {ce_w:.3e} (atol {TRAIN_ATOL})")
    check(differ == 0, f"{tag}: {differ} plan entries differ captured vs eager")
    check(ce_rel <= TRAIN_RTOL and ce_w <= TRAIN_ATOL,
          f"{tag}: captured vs eager losses {ce_rel}, weights {ce_w}")
    check_gradients(tag, first["cuda"], first["eager"], "captured vs eager")

    t0 = time.perf_counter()
    cpu = run("cpu", cpu_steps)
    print(f"{tag} cpu train (plain path, {cpu_steps} steps): {time.perf_counter() - t0:.2f} s; "
          "per step " + "; ".join(f"{ms:.1f} ms" for ms in cpu.step_ms))

    entries = differ = 0
    for step, (a, b) in enumerate(zip(plans["cuda"], plans["cpu"])):
        la, lb = int_leaves(a), int_leaves(b)
        check(set(la) == set(lb), f"step {step}: plan leaves {sorted(la)} vs {sorted(lb)}")
        for name in la:
            check(la[name].dtype == lb[name].dtype, f"step {step}: {name}: dtype differs")
            entries += la[name].numel()
            differ += int((la[name].cpu() != lb[name]).sum())
        sa, sb = a.stats(), b.stats()
        check(sa == sb, f"step {step}: plan_stats card {sa} != cpu {sb}")
        print(f"{tag} step {step} plan_stats (equal on card and cpu): {sa}")
    print(f"{tag} plan leaves card vs cpu: {entries} entries over {cpu_steps} steps, "
          f"{differ} differ")
    check(differ == 0, f"{differ} plan entries differ from the CPU build")

    check(bool(np.isfinite(card.losses).all()), f"non-finite losses {card.losses}")
    lc, lp = np.asarray(card.losses[:cpu_steps]), np.asarray(cpu.losses)
    loss_rel = float(np.max(np.abs(lc - lp) / np.abs(lp)))
    print(f"{tag} losses card {card.losses} cpu {lp.tolist()}: max rel diff "
          f"{loss_rel:.3e} over the first {cpu_steps} (rtol {TRAIN_RTOL})")
    check(loss_rel <= TRAIN_RTOL, f"losses differ from the CPU run by {loss_rel}")
    check_gradients(tag, first["cuda"], first["cpu"])
    if cpu_steps == tc.num_steps:
        w_err = max(float(np.abs(a[k] - b[k]).max())
                    for a, b in zip(card.params["layers"], cpu.params["layers"]) for k in a)
        print(f"{tag} final weights card vs cpu: max abs diff {w_err:.3e} (atol {TRAIN_ATOL})")
        check(w_err <= TRAIN_ATOL, f"final weights differ from the CPU run by {w_err}")
    else:
        print(f"{tag} final weights card vs cpu: not compared (the CPU ran {cpu_steps} of "
              f"{tc.num_steps} steps)")
    walls = card.step_ms
    profile_train(tag, tds, gnn_cfg, tc, [st["plan"] for st in card.stage_ms], walls)
    return {"launches": launches, "loss_rel": loss_rel, "walls": walls,
            "plan0": plans["cuda"][0], "plans": [host_leaves(p) for p in plans["cuda"]],
            "losses": card.losses, "first": first["cuda"]}


def check_gradients(tag: str, card: dict, cpu: dict, what: str = "card vs cpu") -> None:
    """The initial weights equal, card against CPU, and each parameter's
    step-0 gradient within ``GRAD_RTOL`` of that parameter's largest
    ``|g|`` on the CPU.  (Adam's first step, ``lr * g / (|g| + eps)``,
    keeps only the gradient's sign where ``|g|`` is well above ``eps``, and
    turns float32 reorderings of gradients near ``eps`` into weight gaps of
    up to ``lr``; so the gradients are held, not the weights after it.)"""
    import numpy as np

    worst, where = 0.0, ""
    for name, c0, p0, cg, pg in zip(cpu["names"], card["init"], cpu["init"], card["grad"],
                                    cpu["grad"]):
        check(np.array_equal(c0, p0), f"initial weights {name} differ between card and CPU")
        scale = float(np.abs(pg).max())
        gap = float(np.abs(cg - pg).max())
        check(gap <= GRAD_RTOL * scale, f"step-0 gradient {name}: max abs diff {gap:.3e} > "
              f"{GRAD_RTOL} x its largest |g| {scale:.3e}")
        rel = gap / scale if scale else 0.0
        if rel >= worst:
            worst, where = rel, name
    print(f"{tag} step 0 {what}: initial weights equal; gradients within {worst:.3e} of "
          f"each parameter's largest |g| (worst {where}; bound {GRAD_RTOL}), over "
          f"{len(cpu['names'])} parameters")


def phase_coo(plan) -> dict:
    """``layer_to_coo(backend="fused")`` on PE 0's block of every layer of a
    card plan (``cap_edges`` = its ``n * w`` slots), counters zeroed right
    before; every output must equal the CPU's ``layer_to_coo`` on the same
    plan, and ``expand_indptr`` must have launched."""
    import torch
    from repro_torch.core import MinibatchLayer, layer_to_coo
    from repro_torch.kernels import LAUNCHES, reset_launches

    blocks = [MinibatchLayer(layer.seeds[0], layer.self_idx[0], layer.nbr_idx[0],
                             layer.mask[0], None) for layer in plan.layers]
    reset_launches()
    got = [layer_to_coo(blk, blk.mask.numel(), backend="fused") for blk in blocks]
    torch.cuda.synchronize()
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    for k in PATH_KERNELS["coo"]:
        check(launches[k] > 0, f"kernel {k} was not launched by layer_to_coo")
    for l, (blk, out) in enumerate(zip(blocks, got)):
        cpu = MinibatchLayer(*(t.cpu() for t in (blk.seeds, blk.self_idx, blk.nbr_idx,
                                                  blk.mask)), None)
        want = layer_to_coo(cpu, cpu.mask.numel(), backend="fused")
        for name, a, b in zip(("rows", "cols", "indptr"), out, want):
            check(torch.equal(a.cpu(), b), f"layer_to_coo layer {l} {name} differs from the CPU")
        print(f"coo layer {l}: n={blk.mask.shape[0]} w={blk.mask.shape[1]} edges "
              f"{int(want[2][-1])}, rows/cols/indptr equal to the CPU's")
    print(f"coo launches {launches}")
    return {"launches": launches}


def phase_compiled(tag: str, tds, cfg, cpu: bool = True) -> dict:
    """``plan_at`` as one captured program on a fresh card engine of
    ``cfg``: the first call (the eager warm-up, then the capture), then at
    each of ``COMPILED_STEPS`` a replay and the eager build of the same
    step state (``plan_program.fn``), both timed by the host clock to a
    sync, equal bit for bit to each other and, with ``cpu``, to the CPU
    engine's plan and seeds.  The program must be captured once.  Then 3
    replays under the profiler: device ms and kernels a replay, and the
    share of copy kernels, float64 arithmetic, the plan's hand-written
    kernels and the sorts.  Returns the times, the capture's ms, pool
    bytes and launches a replay."""
    import torch
    from repro_torch.engine import MinibatchEngine

    card = MinibatchEngine.from_config(tds.graph, cfg, dataset=tds, device="cuda")
    host = MinibatchEngine.from_config(tds.graph, cfg, dataset=tds, device="cpu") if cpu else None
    prog, key = card.plan_program, cfg.local_batch
    check(card.captures, f"{tag}: the card engine does not capture plan_at")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.plan_at(COMPILED_STEPS[0])
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    rec = prog.report()[key]
    replay_ms, eager_ms, cpu_ms = [], [], []
    for step in COMPILED_STEPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan, seeds = card.plan_and_seeds(step)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eager, eager_seeds = prog.fn(card.step_state(step))
        torch.cuda.synchronize()
        replay_ms.append(1e3 * (t1 - t0))
        eager_ms.append(1e3 * (time.perf_counter() - t1))
        got = int_leaves(plan)
        others = [("eager", int_leaves(eager), eager_seeds)]
        if host is not None:
            t0 = time.perf_counter()
            want, want_seeds = host.plan_and_seeds(step)
            cpu_ms.append(1e3 * (time.perf_counter() - t0))
            others.append(("cpu", int_leaves(want), want_seeds))
        for what, leaves, s in others:
            check(torch.equal(seeds.cpu(), s.cpu()), f"{tag} step {step}: seeds differ ({what})")
            check(set(got) == set(leaves), f"{tag} step {step}: plan leaves differ ({what})")
            for name in got:
                check(got[name].dtype == leaves[name].dtype
                      and torch.equal(got[name].cpu(), leaves[name].cpu()),
                      f"{tag} step {step}: replayed plan leaf {name} differs ({what})")
    check(prog.compiles == {key: 1}, f"{tag}: plan_at compiles {prog.compiles}, want one")
    # where a replay's device time goes
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for step in range(1, 1 + reps):
            card.plan_at(step)
        torch.cuda.synchronize()
    stats = cuda_kernel_us(prof)
    part = lambda keys: sum(us for us, _, k in stats if any(p in k for p in keys)) / 1e3 / reps
    busy = sum(us for us, _, _ in stats) / 1e3 / reps
    print(f"{tag} plan_at replay profile ({reps} replays): device busy {busy:.3f} ms and "
          f"{sum(c for _, c, _ in stats) / reps:.0f} kernels a replay; of it copy kernels "
          f"{part(REPLAY_COPIES):.3f} ms, float64 arithmetic {part(REPLAY_FLOAT64):.3f} ms, "
          f"the hand-written kernels {part(PLAN_KERNELS):.3f} ms, every torch.sort "
          f"{part(PROFILE_GROUPS['every torch.sort']):.3f} ms")
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    print(f"{tag} plan_at captured: first call (eager warm-up + capture) {first_ms:.1f} ms, of "
          f"it capture {rec['capture_ms']:.1f} ms; pool grown {rec['pool_bytes']} B; launches a "
          f"replay {rec['launches']}; steps {list(COMPILED_STEPS)}: replayed ms {fmt(replay_ms)}"
          f"; eager ms {fmt(eager_ms)}; plans and seeds equal bit for bit replayed vs eager"
          + (f" vs cpu (cpu ms {fmt(cpu_ms)})" if cpu else "") + f"; compiles {prog.compiles}")
    return {"first_ms": first_ms, "replay_ms": replay_ms, "eager_ms": eager_ms, **rec}


def phase_plans(tds, tc) -> dict:
    """One cooperative ``plan_at(0)`` with each of the ``rw`` and ``full``
    samplers on the card and on the CPU, counters zeroed right before the
    card's: every integer leaf and ``plan_stats`` equal, the path's kernels
    launched.  Returns the launches by path."""
    import torch
    from repro_torch.engine import MinibatchEngine
    from repro_torch.kernels import LAUNCHES, reset_launches

    out = {}
    for sampler in ("rw", "full"):
        cfg = dataclasses.replace(tc, sampler=sampler).engine_config(3)
        plans, secs = {}, {}
        for dev in ("cuda", "cpu"):
            engine = MinibatchEngine.from_config(tds.graph, cfg, dataset=tds, device=dev)
            reset_launches()
            t0 = time.perf_counter()
            plans[dev] = engine.plan_at(0)
            if dev == "cuda":
                torch.cuda.synchronize()
                out[f"plan_{sampler}"] = {k: LAUNCHES.get(k, 0) for k in KERNELS}
            secs[dev] = time.perf_counter() - t0
        for k in PATH_KERNELS[f"plan_{sampler}"]:
            check(out[f"plan_{sampler}"][k] > 0, f"{sampler} plan: kernel {k} not launched")
        la, lb = int_leaves(plans["cuda"]), int_leaves(plans["cpu"])
        check(set(la) == set(lb), f"{sampler} plan leaves {sorted(la)} vs {sorted(lb)}")
        entries = sum(t.numel() for t in lb.values())
        differ = sum(int((la[n].cpu() != lb[n]).sum()) for n in la)
        check(differ == 0, f"{sampler} plan: {differ} entries differ from the CPU build")
        stats = plans["cuda"].stats()
        check(stats == plans["cpu"].stats(), f"{sampler} plan_stats differ from the CPU's")
        print(f"phase7 {sampler} plan_at(0): {entries} entries equal to the CPU's; card "
              f"{secs['cuda']:.2f} s cpu {secs['cpu']:.2f} s; plan_stats {stats}; launches "
              f"{ {k: v for k, v in out[f'plan_{sampler}'].items() if v} }")
    return out


def phase_curves(graph) -> dict:
    """The work curves of Thm 3.1/3.2 (``measure_work_curve``, 3 layers,
    fanout 10) for ``ns``, ``labor0``, ``labor*`` and ``rw`` at batch sizes
    64, 256 and 1,024, 2 trials each, on the card (``backend="fused"``
    samplers) and on the CPU: the counts must be equal.  Returns the
    card's launches."""
    from repro_torch.core.samplers import make_sampler
    from repro_torch.core.theory import is_concave, is_monotone_nonincreasing, measure_work_curve
    from repro_torch.kernels import LAUNCHES, reset_launches

    gpu = graph.to("cuda")
    reset_launches()
    for name in ("ns", "labor0", "labor*", "rw"):
        curves, secs = {}, {}
        for dev, g in (("cuda", gpu), ("cpu", graph)):
            t0 = time.perf_counter()
            curves[dev] = measure_work_curve(g, make_sampler(name, fanout=10, backend="fused"),
                                             CURVE_BATCHES, num_layers=3, trials=2)
            secs[dev] = time.perf_counter() - t0
        a, b = curves["cuda"], curves["cpu"]
        check(a.expected_sl == b.expected_sl, f"{name} work curve: card {a.expected_sl} "
              f"!= cpu {b.expected_sl}")
        print(f"phase7 work curve {name} (equal on card and cpu): batch {a.batch_sizes} "
              f"E|S^3| {a.expected_sl} per seed {[round(x, 3) for x in a.work_per_seed]}; "
              f"nonincreasing {is_monotone_nonincreasing(a.work_per_seed)}, concave "
              f"{is_concave(a.batch_sizes, a.expected_sl)}; card {secs['cuda']:.2f} s "
              f"cpu {secs['cpu']:.2f} s")
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    for k in PATH_KERNELS["curves"]:
        check(launches[k] > 0, f"work curves: kernel {k} not launched")
    return launches


# --------------------------------------------------------------------------
# phase 8
# --------------------------------------------------------------------------
def dependent_config(tc, mode: str, kappa):
    """Phase 3's engine configuration (3 layers) in ``mode`` at ``kappa``,
    with the tiered cache on (V // 4 rows and 8 ways per PE)."""
    from repro_torch.engine import CacheConfig, EngineConfig

    return EngineConfig(
        mode=mode, num_pes=tc.num_pes, local_batch=tc.local_batch, num_layers=3,
        sampler=tc.sampler, fanout=tc.fanout, schedule=tc.schedule, kappa=kappa,
        partition=tc.partition, seed=tc.seed, plan_backend=tc.plan_backend,
        executor=tc.executor, cache=CacheConfig(enabled=True),
    )


def same_items(a, b, what: str) -> None:
    """Two stream items equal: step, seeds, every integer plan leaf and the
    features, bit for bit (``b`` may live on the CPU)."""
    import numpy as np
    import torch

    check(a.step == b.step, f"{what}: step {a.step} != {b.step}")
    check(np.array_equal(a.seeds, b.seeds), f"{what} step {a.step}: seeds differ")
    la, lb = int_leaves(a.plan), int_leaves(b.plan)
    check(set(la) == set(lb), f"{what} step {a.step}: plan leaves {sorted(la)} vs {sorted(lb)}")
    for name in la:
        check(la[name].dtype == lb[name].dtype and torch.equal(la[name].cpu(), lb[name].cpu()),
              f"{what} step {a.step}: plan leaf {name} differs")
    check(a.features.shape == b.features.shape
          and torch.equal(a.features, b.features.to(a.features.device)),
          f"{what} step {a.step}: features differ")


def clock_counters(state) -> tuple:
    """Per-PE (hits, misses, requested) of a CLOCK state, as host lists."""
    return tuple(tuple(getattr(state, k).cpu().tolist()) for k in ("hits", "misses", "requested"))


def lap(split: dict, key: str, t0: float) -> float:
    """Add the ms since ``t0`` to ``split[key]``; returns the time now."""
    now = time.perf_counter()
    split[key] += 1e3 * (now - t0)
    return now


def phase_dependent(ds, tc) -> dict:
    """Phase 8: the κ sweep of §4.2 through ``engine.stream(fetch_features=
    True)``, consumed by the LRU oracle, a card and a CPU ``ClockCache``
    (and, in independent mode, ``count_duplicates_across_pes``), with the
    checks of the module docstring.  Counters are zeroed at the start and
    read at the end: every card run of the phase is the path.  Returns the
    launches."""
    import numpy as np
    import torch
    from repro_torch.core import INVALID, CooperativeCacheArray
    from repro_torch.engine import MinibatchEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.store import ClockCache, unique_rows

    t_phase = time.perf_counter()
    P = tc.num_pes
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    lru_rate = {}
    for mode in DEP_MODES:
        for kappa in DEP_KAPPAS:
            tag = f"phase8 {mode} kappa={kappa if kappa else 'inf'}"
            cfg = dependent_config(tc, mode, kappa)
            t0 = time.perf_counter()
            engine = MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device="cuda")
            setup_s = time.perf_counter() - t0
            tiered = engine.tiered
            rows, ways = tiered.capacity, tiered.ways
            lru = CooperativeCacheArray(P, rows)
            card, cpu = (ClockCache(rows, ways, num_pes=P, device=d) for d in ("cuda", "cpu"))
            before = {k: LAUNCHES.get(k, 0) for k in KERNELS}
            kept, walls, dups = [], [], 0
            split = dict.fromkeys(("compact", "lru", "card clock", "cpu clock", "dups"), 0.0)
            it = iter(engine.stream(DEP_STEPS, prefetch=2, fetch_features=True))
            for step in range(DEP_STEPS):
                t0 = time.perf_counter()
                item = next(it)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
                ids = item.plan.input_ids
                # the host consumers take each PE's sorted unique ids with the
                # INVALID padding cut: the same accesses, a few thousand ids
                # a PE where the plan pads to 262,144
                t0 = time.perf_counter()
                uniq = unique_rows(ids)
                host_ids = uniq[:, :int((uniq != INVALID).sum(1).max())].cpu()
                t0 = lap(split, "compact", t0)
                lru.access(host_ids)
                t0 = lap(split, "lru", t0)
                card.access(ids)
                t0 = lap(split, "card clock", t0)
                cpu.access(host_ids)
                t0 = lap(split, "cpu clock", t0)
                if mode == "independent":
                    dups += engine.store.count_duplicates_across_pes(host_ids)
                    lap(split, "dups", t0)
                if kappa == 16 and step < DEP_PREFETCH_ITEMS:
                    kept.append(item)
            torch.cuda.synchronize()
            per = {k: (LAUNCHES.get(k, 0) - before[k]) / DEP_STEPS
                   for k in PATH_KERNELS["dependent"]}
            check(per["tag_probe"] == 2, f"{tag}: {per['tag_probe']} tag_probe launches a "
                  "step, want 2 (the tiered store's and the ClockCache's)")
            counters = {"tiered": clock_counters(tiered.state), "card ClockCache":
                        clock_counters(card.state), "cpu ClockCache": clock_counters(cpu.state)}
            check(len(set(counters.values())) == 1,
                  f"{tag}: per-PE (hits, misses, requested) differ: {counters}")
            lru_rate[mode, kappa] = lru.miss_rate
            mb = tiered.fetched_rows * tiered.host.shape[1] * tiered.host.element_size() / 1e6
            print(f"{tag}: LRU miss rate {lru.miss_rate:.6f}, CLOCK {card.miss_rate:.6f} (gap "
                  f"{card.miss_rate - lru.miss_rate:+.6f}); per-PE (hits, misses, requested) "
                  f"{counters['tiered']} equal in the tiered store and both ClockCaches; "
                  f"fetched rows {tiered.fetched_rows} ({tiered.fetched_rows / DEP_STEPS:.1f} a "
                  f"step, {mb / DEP_STEPS:.2f} MB a step)"
                  + (f"; duplicate fetches across PEs {dups} ({dups / DEP_STEPS:.1f} a step)"
                     if mode == "independent" else "")
                  + f"; wall ms a stream step (prefetch 2) mean {sum(walls) / DEP_STEPS:.3f} "
                  f"[{min(walls):.3f}-{max(walls):.3f}]; consumers ms a step "
                  + ", ".join(f"{k} {v / DEP_STEPS:.3f}" for k, v in split.items() if v)
                  + f"; launches a step {per}; engine set-up {setup_s:.2f} s")
            for prog in (tiered.access_program, tiered.assemble_program):
                check(prog.capture and list(prog.compiles.values()) == [1]
                      and list(prog.captures.values()) == [1],
                      f"{tag}: {prog.name} compiles {prog.compiles}, captures {prog.captures}, "
                      "want one capture")
                if kappa == 16:
                    print(f"{tag}: {prog.name} (the tiered store's program) captured once: "
                          + "; ".join(f"{k}: {r['capture_ms']:.1f} ms, {r['pool_bytes']} B, "
                                      f"launches a replay {r['launches']}"
                                      for k, r in prog.report().items()))
            if kappa != 16:
                continue
            # prefetch 0 against prefetch 2 on a fresh engine; at prefetch 0
            # item i is yielded after exactly i + 1 gathers, so its store is
            # read after as many gathers as the CPU stream's below
            fresh = MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device="cuda")
            p0_walls, it = [], iter(fresh.stream(DEP_PREFETCH_ITEMS, prefetch=0,
                                                 fetch_features=True))
            for i, a in enumerate(kept):
                t0 = time.perf_counter()
                b = next(it)
                torch.cuda.synchronize()
                p0_walls.append(1e3 * (time.perf_counter() - t0))
                same_items(a, b, f"{tag} prefetch 2 vs 0")
                if i == DEP_CPU_ITEMS - 1:
                    got = clock_counters(fresh.tiered.state) + (fresh.tiered.fetched_rows,)
            check(engine.captures and engine.plan_program.compiles == {tc.local_batch: 1},
                  f"{tag}: plan_at compiles {engine.plan_program.compiles}, want one capture")
            eager_ms = []
            for a in kept:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eager, eager_seeds = engine.plan_program.fn(engine.step_state(a.step))
                torch.cuda.synchronize()
                eager_ms.append(1e3 * (time.perf_counter() - t0))
                la, lb = int_leaves(a.plan), int_leaves(eager)
                check(np.array_equal(a.seeds, eager_seeds.cpu().numpy()) and set(la) == set(lb)
                      and all(torch.equal(la[n], lb[n]) for n in la),
                      f"{tag} step {a.step}: the stream's plan differs from the eager build")
            print(f"{tag}: the first {len(kept)} items' plans (replayed) equal the eager build "
                  f"bit for bit; eager plan ms {', '.join(f'{x:.3f}' for x in eager_ms)}; "
                  f"capture {engine.plan_program.report()}")
            t0 = time.perf_counter()
            host = MinibatchEngine.from_config(ds.graph, cfg, dataset=ds, device="cpu")
            cpu_items = list(host.stream(DEP_CPU_ITEMS, prefetch=0, fetch_features=True))
            cpu_s = time.perf_counter() - t0
            for a, b in zip(kept, cpu_items):
                same_items(a, b, f"{tag} card vs cpu")
            want = clock_counters(host.tiered.state) + (host.tiered.fetched_rows,)
            check(got == want, f"{tag}: tiered counters card {got} != cpu {want}")
            print(f"{tag}: the first {DEP_PREFETCH_ITEMS} items equal at prefetch 0 and 2, the "
                  f"first {DEP_CPU_ITEMS} equal to the CPU's ({cpu_s:.2f} s), tiered counters "
                  f"after {DEP_CPU_ITEMS} gathers equal (per-PE hits, misses, requested; "
                  f"fetched rows {got[-1]}); wall ms a stream step prefetch 0 mean "
                  f"{sum(p0_walls) / len(p0_walls):.3f} [{min(p0_walls):.3f}-{max(p0_walls):.3f}]"
                  f" over {DEP_PREFETCH_ITEMS} steps against prefetch 2 "
                  f"{sum(walls) / DEP_STEPS:.3f} over {DEP_STEPS} (the first next() builds 2 "
                  "items); warm steps (a next() that builds one item, the capture's first "
                  f"call excluded): prefetch 0 median {float(np.median(p0_walls[1:])):.3f} "
                  f"[{min(p0_walls[1:]):.3f}-{max(p0_walls[1:]):.3f}] over "
                  f"{len(p0_walls) - 1}, prefetch 2 median {float(np.median(walls[1:-1])):.3f} "
                  f"[{min(walls[1:-1]):.3f}-{max(walls[1:-1]):.3f}] over {len(walls) - 2}; "
                  "the same steps' builds (same cache state), steps 2.."
                  f"{DEP_PREFETCH_ITEMS - 1}: prefetch 0 "
                  f"{', '.join(f'{x:.3f}' for x in p0_walls[2:])}, prefetch 2 "
                  f"{', '.join(f'{x:.3f}' for x in walls[1:DEP_PREFETCH_ITEMS - 1])}")
            del kept, a, b, it, cpu_items, fresh, host
        r1, rinf = lru_rate[mode, 1], lru_rate[mode, None]
        print(f"phase8 {mode}: LRU miss rate kappa=1 {r1:.6f}, kappa=inf {rinf:.6f}, ratio "
              f"{r1 / rinf if rinf else float('inf'):.4f}")
        check(rinf < r1, f"phase8 {mode}: LRU miss rate at kappa=inf {rinf} is not below "
              f"kappa=1's {r1}")
    torch.cuda.synchronize()
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    for k in PATH_KERNELS["dependent"]:
        check(launches[k] > 0, f"kernel {k} was not launched on the dependent path")
    print(f"phase8: {time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 9
# --------------------------------------------------------------------------
def shard_rank(rank: int, world: int, backend: str, store: str, out_dir: str, device: str,
               tds, gnn_cfg, tc, modes: tuple) -> None:
    """One rank of phase 9, in a process of its own: ``train_gnn`` with
    ``executor="shard"`` for this rank's PE once per mode of ``modes``:
    ``"captured"`` through the step program (one CUDA graph under NCCL)
    and ``"staged"`` (gloo: the program runs eagerly), both with stage
    times (``stage_times=True``, its spans read after each step), and
    ``"eager"`` through the program's body run eagerly
    (:func:`train_eager`), each from the seeded weights, counters zeroed
    right before.  After each step (``on_step``): the launches, the
    stacked plan (``stack_plan``, an all-gather) and whether every rank's
    weights are equal bit for bit (an all-gather); at step 0 the
    all-reduced gradient (tensor hooks read this rank's share during the
    step: a captured run's step 0 is the program's eager warm-up).  After
    a captured run: the step program's capture report, and the plan
    program's replays timed (``ShardRunner.plan_at``, each ended by a
    sync).  Writes its results to ``out_dir/rank{rank}.pt``.  The kernels
    must be built already: a rank only loads them."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.engine import MinibatchEngine
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.models.gnn import init_gnn
    from repro_torch.train import train_gnn

    laps = [time.perf_counter()]
    tds = host_tensors(tds, back=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    dev = torch.device(device)
    if dev.type == "cuda":
        missing = [n for n, src in _build.sources().items() if not _build._target(src).exists()]
        check(not missing, f"rank {rank}: kernels {missing} were not built before the ranks")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_COLLECTIVE_S))
    laps.append(time.perf_counter())
    try:
        tc = dataclasses.replace(tc, executor="shard")
        runner = MinibatchEngine.from_config(tds.graph, tc.engine_config(gnn_cfg.num_layers),
                                             dataset=tds, device=dev).shard_runner
        out = {"rank": rank, "backend": backend, "runs": {}}
        laps.append(time.perf_counter())
        for mode in modes:
            model = init_gnn(gnn_cfg, seed=tc.seed, device=dev)
            params = list(model.parameters())
            share = {}

            def keep(i, g):
                share.setdefault(i, g.detach().clone())

            hooks = [p.register_hook(functools.partial(keep, i)) for i, p in enumerate(params)]
            run = {"launches": [], "plans": [], "same": [],
                   "init": [p.detach().cpu().numpy().copy() for p in params]}

            def on_step(step, plan):
                run["launches"].append({k: LAUNCHES.get(k, 0) for k in KERNELS})
                if step == 0:
                    for h in hooks:
                        h.remove()
                    flat = torch.cat([share[i].reshape(-1) for i in range(len(params))])
                    dist.all_reduce(flat)
                    run["grad"] = [g.view_as(p).cpu().numpy()
                                   for g, p in zip(flat.split([p.numel() for p in params]),
                                                   params)]
                stacked = host_leaves(runner.stack_plan(plan))
                run["plans"].append(stacked if rank == 0 else None)
                w = torch.cat([p.detach().reshape(-1) for p in params])
                every = [torch.empty_like(w) for _ in range(world)]
                dist.all_gather(every, w)
                run["same"].append(all(torch.equal(x, every[0]) for x in every))

            reset_launches()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            if mode == "eager":
                res = train_eager(tds, gnn_cfg, tc, model, dev, on_step)
            else:
                res = train_gnn(tds, gnn_cfg, tc, model=model, device=dev, stage_times=True,
                                on_step=on_step)
            run["seconds"] = time.perf_counter() - t0
            prev = {k: 0 for k in KERNELS}
            for i, cum in enumerate(run["launches"]):
                run["launches"][i] = {k: cum[k] - prev[k] for k in KERNELS if cum[k] - prev[k]}
                prev = cum
            run.update(losses=res.losses, stage_ms=res.stage_ms, step_ms=res.step_ms,
                       exchanges=res.exchanges, compiled=res.compiled,
                       weights=[p.detach().cpu().numpy().copy() for p in params],
                       total={k: v for k, v in prev.items() if v},
                       peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
            if mode == "captured":
                run["plan_ms"] = []
                for step in range(tc.num_steps):  # the first call captures
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    runner.plan_at(step)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    run["plan_ms"].append(1e3 * (time.perf_counter() - t0))
                run["plan_program"] = (runner.plan_program.capture,
                                       dict(runner.plan_program.compiles),
                                       runner.plan_program.report())
            out["runs"][mode] = run
        laps.append(time.perf_counter())
        out["laps"] = [b - a for a, b in zip(laps, laps[1:])]
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def host_tensors(ds, back: bool = False):
    """A shallow copy of dataset ``ds`` with its numpy arrays as CPU tensors
    (``back``: its CPU tensors as numpy arrays).  A spawned rank gets
    tensors through shared memory; numpy arrays go into the pipe, which the
    child reads only once it has imported torch, so each start would wait
    for the previous rank to boot."""
    import copy

    import numpy as np
    import torch

    out = copy.copy(ds)
    for k, v in vars(ds).items():
        if back and isinstance(v, torch.Tensor):
            setattr(out, k, v.numpy())
        elif not back and isinstance(v, np.ndarray):
            setattr(out, k, torch.from_numpy(v).clone())
    return out


def run_ranks(backend: str, world: int, run_dir: Path, tds, gnn_cfg, tc,
              device: str = "cuda", modes: tuple = ("staged",)) -> list:
    """``world`` processes of :func:`shard_rank` (``spawn``), one FileStore;
    fails as soon as one rank fails, and at ``SHARD_DEADLINE_S`` kills them
    all.  Returns each rank's results."""
    import multiprocessing.connection

    import torch
    import torch.multiprocessing

    ctx = torch.multiprocessing.get_context("spawn")
    store = run_dir / f"store-{backend}-{world}"
    shared = host_tensors(tds)
    procs = [ctx.Process(target=shard_rank, args=(r, world, backend, str(store), str(run_dir),
                                                  device, shared, gnn_cfg, tc, modes))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_DEADLINE_S
    try:
        while any(p.exitcode is None for p in procs) and time.monotonic() < deadline:
            multiprocessing.connection.wait([p.sentinel for p in procs if p.exitcode is None],
                                            timeout=max(deadline - time.monotonic(), 0.1))
            if any(p.exitcode not in (None, 0) for p in procs):
                break
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"{backend} ranks exited {codes} (None: still running, "
              f"killed at the {SHARD_DEADLINE_S} s deadline or after another rank failed)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    return [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def phase_shard(tds, gnn_cfg, tc, p3: dict, device: str = "cuda") -> dict:
    """Phase 3's configuration with ``executor="shard"``: 9a, ``num_pes``
    ranks on the one card over gloo (CUDA tensors, staged through host
    memory by gloo), through the staged step (``stage_times=True``;
    gloo's collectives run on the host: nothing to capture); 9b, one rank
    over NCCL (P = 1), so NCCL's all-to-all and all-reduce run on the
    card: first through the step program with stage times (one captured
    CUDA graph), then the same steps through its body run eagerly.
    Checked against phase 3's card SimExecutor run
    (``p3``) for 9a and a P = 1 SimExecutor's on the card for 9b: every
    step's stacked plan bit for bit, the losses, 9a's step-0 gradients;
    the ranks' weights equal bit for bit after every step, each rank's
    launches per step; 9b's captured run against its eager run: plans
    bit for bit, losses, final weights and step-0 gradients as phase 3
    holds the CPU's, one capture.  Returns the launches (all ranks, all
    runs).  ``device="cpu"`` rehearses it on the CPU at a small size
    (gloo both times, CPU tensors, the program eager)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.engine import MinibatchEngine
    from repro_torch.train import train_gnn

    t_phase = time.perf_counter()
    L = gnn_cfg.num_layers
    want = {"frontier_gather": L, "unique_compact": 2 * L + 1, "gather": 1, "spmm": L,
            "spmm_backward": L - 1}
    run_dir = ROOT / "build" / "phase9"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    card = device == "cuda"
    if card:
        torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    else:
        want = {}  # the plain versions launch nothing
    total = {k: 0 for k in KERNELS}
    try:
        for tag, backend, P, modes in (
                ("phase9a", "gloo", tc.num_pes, ("staged",)),
                ("phase9b", "nccl" if card else "gloo", 1, ("captured", "eager"))):
            run_tc = dataclasses.replace(tc, num_pes=P)
            t0 = time.perf_counter()
            ranks = run_ranks(backend, P, run_dir, tds, gnn_cfg, run_tc, device, modes)
            where = f"one card ({torch.cuda.get_device_name(0)})" if card else "the CPU"
            print(f"{tag}: backend {backend}, {P} rank(s) on {where}, {run_tc.num_steps} "
                  f"steps a run, runs {list(modes)}, in {time.perf_counter() - t0:.1f} s "
                  "(process start included)")
            if backend == "gloo":
                print(f"{tag}: the step runs eagerly, by configuration: gloo's collectives run "
                      "on the host and cannot be recorded into a CUDA graph (an NCCL group "
                      "captures, 9b)")
                print(f"{tag} caveat: the ranks share one card and gloo stages every exchange "
                      "through host memory between processes; these exchange times say "
                      "nothing about an NVLink all-to-all between cards")
            if P == tc.num_pes:
                ref_plans, ref_losses = p3["plans"], p3["losses"]
            else:
                engine = MinibatchEngine.from_config(tds.graph, run_tc.engine_config(L),
                                                     dataset=tds, device=device)
                ref_plans = [host_leaves(engine.plan_at(s)) for s in range(run_tc.num_steps)]
                ref_losses = train_gnn(tds, gnn_cfg, run_tc, device=device).losses
            for mode in modes:
                runs = [r["runs"][mode] for r in ranks]
                for r, run in zip(ranks, runs):
                    check(r["backend"] == backend, f"rank {r['rank']} ran {r['backend']}")
                    check(all(run["same"]), f"{tag} {mode} rank {r['rank']}: weights differ "
                          f"between ranks after steps "
                          f"{[i for i, s in enumerate(run['same']) if not s]}")
                    for step, got in enumerate(run["launches"]):
                        check(got == want, f"{tag} {mode} rank {r['rank']} step {step}: "
                              f"launches {got}, want {want}")
                    check(run["losses"] == runs[0]["losses"],
                          f"{tag} {mode}: losses differ between ranks")
                    for k, v in run["total"].items():
                        total[k] += v
                    report_rank(f"{tag} {mode}", r["rank"], run, P)
                check(len(ref_plans) == len(runs[0]["plans"]) == run_tc.num_steps,
                      f"{tag} {mode}: {len(runs[0]['plans'])} plans")
                entries = 0
                for step, (got, ref) in enumerate(zip(runs[0]["plans"], ref_plans)):
                    check(set(got) == set(ref), f"{tag} {mode} step {step}: leaves "
                          f"{sorted(got)} vs {sorted(ref)}")
                    for name, v in got.items():
                        w = ref[name]
                        check(v.dtype == w.dtype and np.array_equal(v, w),
                              f"{tag} {mode} step {step}: plan leaf {name} differs from the "
                              "SimExecutor's")
                        entries += v.size
                losses = runs[0]["losses"]
                rel = float(np.max(np.abs(np.asarray(losses) - ref_losses) / np.abs(ref_losses)))
                print(f"{tag} {mode}: stacked plans equal the card SimExecutor's (P = {P}): "
                      f"{entries} entries over {len(ref_plans)} steps; losses {losses} vs "
                      f"{list(ref_losses)}: max rel diff {rel:.3e} (rtol {TRAIN_RTOL}); weights "
                      f"equal on every rank after every step; launches per rank step {want}")
                check(rel <= TRAIN_RTOL, f"{tag} {mode}: losses differ from the SimExecutor's "
                      f"by {rel}")
                if P == tc.num_pes:
                    check_gradients(f"{tag} {mode}", runs[0], p3["first"],
                                    "shard vs card SimExecutor")
            for r in ranks:
                group, setup, runs = r["laps"]
                print(f"{tag} rank {r['rank']}: s in the rank: group {group:.2f}, engine "
                      f"{setup:.2f}, the runs {runs:.2f}")
            if "captured" in modes:
                shard_captured_vs_eager(tag, ranks[0], p3["first"]["names"], card)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    print(f"phase9: {time.perf_counter() - t_phase:.1f} s")
    return total


def shard_captured_vs_eager(tag: str, r: dict, names: list, card: bool) -> None:
    """A rank's captured run against its eager run of the same steps:
    plans bit for bit, losses within ``TRAIN_RTOL``, final weights within
    ``ATOL``, step-0 gradients by :func:`check_gradients`; on a card one
    capture of the step program and of the plan program.  Prints the
    capture's ms, pool bytes and launches a replay, the captured steps'
    wall ms and stage split, and the plan program's replays' ms."""
    import numpy as np

    cap, st = r["runs"]["captured"], r["runs"]["eager"]
    for step, (a, b) in enumerate(zip(cap["plans"], st["plans"], strict=True)):
        check(set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a),
              f"{tag} step {step}: the captured run's plan differs from the eager run's")
    rel = max(abs(x - y) / abs(y) for x, y in zip(cap["losses"], st["losses"], strict=True))
    gap = max(float(np.abs(a - b).max()) for a, b in zip(cap["weights"], st["weights"],
                                                            strict=True))
    check(rel <= TRAIN_RTOL and gap <= ATOL, f"{tag}: captured vs eager losses rel {rel}, "
          f"final weights {gap}")
    check_gradients(f"{tag} captured", cap, {"names": names, **st}, "captured vs eager")
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)  # noqa: E731
    print(f"{tag} captured vs eager: plans equal bit for bit over {len(cap['plans'])} steps; "
          f"losses max rel diff {rel:.3e} (rtol {TRAIN_RTOL}, bit-equal "
          f"{cap['losses'] == st['losses']}); final weights max abs diff {gap:.3e} (atol "
          f"{ATOL})")
    comp = cap["compiled"]
    capture, plan_compiles, plan_rep = cap["plan_program"]
    if card:
        check(bool(comp) and list(comp["captures"].values()) == [1]
              and comp["compiles"] == comp["captures"],
              f"{tag}: the step program's captures {comp}")
        check(capture and len(plan_rep) == 1 and list(plan_compiles.values()) == [1],
              f"{tag}: the plan program's captures {plan_compiles}, {plan_rep}")
    for key, rep in comp.get("report", {}).items():
        print(f"{tag} step program (key {key}): one capture, {rep['capture_ms']:.1f} ms; pool "
              f"grown {rep['pool_bytes']} B; launches a replay {rep['launches']}; "
              f"compiles {comp['compiles']}")
    for key, rep in plan_rep.items():
        print(f"{tag} plan program (key {key}): capture {rep['capture_ms']:.1f} ms, pool "
              f"{rep['pool_bytes']} B, launches a replay {rep['launches']}")
    print(f"{tag} captured: step ms (to the loss's read) {fmt(cap['step_ms'])}; plan_at ms "
          f"(each ended by a sync; the first call captures where it can) "
          f"{fmt(cap['plan_ms'])}; its steps by span "
          f"{fmt([sum(s.values()) for s in cap['stage_ms']])}, their plan "
          f"{fmt([s['plan'] for s in cap['stage_ms']])}; eager step ms {fmt(st['step_ms'])}; "
          f"captured {capture}")


def report_rank(tag: str, rank: int, run: dict, P: int) -> None:
    """One rank's run: each step's span ms by stage (where timed) and the
    exchanges' count, bytes (the buffer handed to ``all_to_all_single``,
    and the part that leaves the rank) and span ms; its peak device memory and its seconds in ``train_gnn``."""
    for step, (st, ex) in enumerate(zip(run["stage_ms"], run["exchanges"])):
        parts = "; ".join(
            f"{kind} x{n} {b} B ({b * (P - 1) // P} B to other ranks) {ms:.3f} ms"
            for kind, (n, b, ms) in ex.items())
        print(f"{tag} rank {rank} step {step}: spans {sum(st.values()):.3f} ms = "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
              + f"; exchanges (ids in plan, forward and backward in forward_backward): {parts}")
    print(f"{tag} rank {rank}: peak device memory {run['peak'] / 2**30:.3f} GiB; train_gnn "
          f"{run['seconds']:.2f} s (its engine and the per-step checks included)")


# --------------------------------------------------------------------------
# phase 10
# --------------------------------------------------------------------------
def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(device: str = "cuda") -> dict:
    """10a: the four examples of the port at their own widths on the card,
    then on the CPU, ``train_cooperative_gnn_torch`` at
    ``EXAMPLE_TRAIN_STEPS`` steps (cut from 300) and on the card also with
    ``plan_backend="fused"`` (its plans equal the plain build's, so both
    card runs are held to the one CPU run).  Integer outputs must be equal,
    losses within ``TRAIN_RTOL``, logits within ``ATOL``; returns the card
    runs' launches.  ``device="cpu"`` rehearses the phase with no card."""
    import numpy as np
    from repro_torch.kernels import LAUNCHES, reset_launches

    quick = load_example("quickstart_torch").quickstart
    dep = load_example("dependent_minibatching_torch").dependent_minibatching
    train = load_example("train_cooperative_gnn_torch").train_cooperative_gnn
    serve = load_example("serve_gnn_torch").serve_gnn
    out_dir = ROOT / "build" / "phase10"
    out_dir.mkdir(parents=True, exist_ok=True)

    def run_all(device: str, backends: tuple) -> dict:
        runs, secs = {}, {}
        for name, fn in (("quickstart", lambda: quick(device=device)),
                         ("dependent", lambda: dep(device=device)),
                         *((f"train[{b}]", functools.partial(
                             train, steps=EXAMPLE_TRAIN_STEPS, plan_backend=b,
                             out=str(out_dir / f"ckpt_{device}_{b}"), device=device))
                           for b in backends),
                         ("serve", lambda: serve(device=device))):
            print(f"phase10a {name} on {device}:")
            t0 = time.perf_counter()
            runs[name] = fn()
            secs[name] = time.perf_counter() - t0
        print(f"phase10a {device} seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
        return runs

    reset_launches()
    card = run_all(device, ("reference", "fused"))
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    print(f"phase10a card launches {launches}")
    for k in PATH_KERNELS["examples"] if device == "cuda" else ():
        check(launches[k] > 0, f"kernel {k} was not launched by the examples")
    cpu = run_all("cpu", ("reference",))

    a, b = card["quickstart"], cpu["quickstart"]
    keys = ("num_vertices", "num_edges", "indep_inputs", "coop_inputs")
    check([a[k] for k in keys] == [b[k] for k in keys],
          f"quickstart counts card {[a[k] for k in keys]} cpu {[b[k] for k in keys]}")
    check(np.allclose(a["losses"], b["losses"], rtol=TRAIN_RTOL, atol=0),
          f"quickstart losses card {a['losses']} cpu {b['losses']}")
    a, b = card["dependent"], cpu["dependent"]
    check(a["miss_rate"] == b["miss_rate"],
          f"LRU miss rates card {a['miss_rate']} cpu {b['miss_rate']}")
    corr_err = max(abs(a["corr"][s] - b["corr"][s]) for s in a["corr"])
    print(f"phase10a dependent: miss rates by kappa {a['miss_rate']} equal; correlations "
          f"card vs cpu max abs diff {corr_err:.3e}")
    want = cpu["train[reference]"]["losses"]
    for backend in ("reference", "fused"):
        got = card[f"train[{backend}]"]
        err = float(np.max(np.abs(np.asarray(got["losses"]) - want) / np.abs(want)))
        print(f"phase10a train[{backend}]: loss rel err card vs cpu {err:.3e} (rtol "
              f"{TRAIN_RTOL}); val F1 card {got['val_f1']} cpu {cpu['train[reference]']['val_f1']}")
        check(err <= TRAIN_RTOL, f"train[{backend}] losses differ from the CPU run by {err}")
    a, b = card["serve"]["reports"], cpu["serve"]["reports"]
    for policy, rep in a.items():
        ref = b[policy]
        check(rep.summary() == ref.summary(),
              f"serve {policy}: card {rep.summary()} cpu {ref.summary()}")
        check([r.bucket for r in rep.batches] == [r.bucket for r in ref.batches],
              f"serve {policy}: buckets differ from the CPU run")
        check(rep.compiles == ref.compiles and all(
            n == 1 for per in rep.compiles.values() for n in per.values()),
            f"serve {policy}: compiles card {rep.compiles} cpu {ref.compiles}")
        by_rid = {s.request.rid: s.pred for s in ref.served}
        err = max(float(np.abs(s.pred - by_rid[s.request.rid]).max()) for s in rep.served)
        check(err <= ATOL, f"serve {policy}: logits differ from the CPU run by {err}")
        print(f"phase10a serve {policy}: accounting equal to the cpu's, compiles "
              f"{rep.compiles}, logits card vs cpu max abs diff {err:.3e}")
    gap = card["serve"]["max_abs_diff"]
    print(f"phase10a serve coalesced vs per-request (card): max abs diff {gap:.3e} (atol {ATOL})")
    check(gap <= ATOL, f"coalesced and per-request logits differ by {gap} on the card")
    check(cpu["serve"]["bit_identical"], "coalesced != per-request predictions on the CPU")
    return launches


def rel(path: str) -> str:
    p = Path(path)
    return str(p.resolve().relative_to(ROOT)) if p.is_absolute() else path


def phase_analysis(ds, serve_cfg, gnn_cfg, device: str = "cuda", train=None) -> dict:
    """10b: ``run_analysis`` over the port on the card (lint, contracts on
    the seven CUDA wrappers, trace); then the host syncs of one served batch,
    of ``hot_path`` and of the tiered gather alone (one on a card: the
    missed ids' read) at each of phase 2's buckets, by both counts; and,
    given ``train = (dataset, gnn_cfg, tc)``, of one replay of the captured
    train step (none).  Fails on RA005, RA107, RA199, RA299 or a wrapper
    without RA100; returns the run's launches.  ``device="cpu"`` rehearses
    the phase with no card."""
    import torch
    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.trace import record_call
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.gnn import init_gnn
    from repro_torch.serve import GNNServer, poisson_trace

    reset_launches()
    t0 = time.perf_counter()
    rep = run_analysis([str(ROOT / "src" / "repro_torch")], passes=["lint", "contracts", "trace"],
                       device=device)
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    print(f"phase10b run_analysis: {time.perf_counter() - t0:.1f} s, rule counts "
          f"{rep.rule_counts()}, launches {launches}")
    for f in sorted(rep.findings, key=lambda f: (f.rule, f.file, f.line)):
        if f.rule in ("RA001", "RA002", "RA004"):
            print(f"phase10b {f.rule} {rel(f.file)}:{f.line} {f.extra}")
    for f in rep.findings:
        if f.rule[:3] == "RA1":
            print(f"phase10b {f.rule} {rel(f.file)}:{f.line} {f.message}")
    bad = [f.render() for f in rep.findings if f.rule in ("RA005", "RA107", "RA199", "RA299")]
    check(not bad, "analysis: " + "; ".join(bad))
    check(sum(f.rule == "RA100" for f in rep.findings) == 7, "not every wrapper verified")
    for f in rep.findings:
        if f.rule in ("RA200", "RA201", "RA202"):
            per_call = ", ".join(
                f"{c['syncs']}/{c['sync_warnings']}" for c in f.extra["calls"])
            print(f"phase10b trace {f.extra['entry']} [{f.rule}]: syncs per call "
                  f"(dispatched/sync-debug warnings) {per_call}; same signature "
                  f"{f.extra['same_signature']}; sites {f.extra['calls'][0]['sites']}")
    for k in PATH_KERNELS["analysis"] if device == "cuda" else ():
        check(launches[k] > 0, f"kernel {k} was not launched by the analysis")

    dev = torch.device(device)
    server = GNNServer(ds.graph, ds.features, gnn_cfg,
                       init_gnn(gnn_cfg, seed=SEED, device=device), serve_cfg, device=device)
    trace = poisson_trace(500, 4000.0, ds.user_ids, seed=SEED)
    for bucket in server.ladder.buckets:
        batch = server.coalescer.coalesce(trace[:bucket], 0.0)
        check(batch.bucket == bucket, f"{bucket} requests coalesced into bucket {batch.bucket}")
        seeds = torch.from_numpy(batch.seeds).to(dev)
        server._execute(batch, 0)  # warm-up: the bucket's engine and cuBLAS
        _, served = record_call(dev, server._execute, batch, 0)
        _, hot = record_call(dev, server.hot_path, seeds)
        _, gather = record_call(dev, server._gather, server._plan(batch.seeds))
        print(f"phase10b served batch at bucket {bucket}: syncs {served.syncs} dispatched / "
              f"{served.sync_warnings} sync-debug warnings ({len(served.ops)} ops; sites "
              f"{served.sites}); hot_path {hot.syncs} / {hot.sync_warnings} "
              f"({len(hot.ops)} ops); the tiered gather {gather.syncs} / "
              f"{gather.sync_warnings} (sites {gather.sites})")
        if device == "cuda":
            check(gather.syncs == 1, f"phase10b bucket {bucket}: the tiered gather syncs "
                  f"{gather.syncs} times, want 1 (the missed ids' read)")
    print(f"phase10b: compiles {server._plan_guard.compiles} (plan), "
          f"{server._forward_guard.compiles} (forward), "
          f"{server.tiered.access_program.compiles} (store.clock_access), "
          f"{server.tiered.assemble_program.compiles} (store.assemble)")
    if train is not None:
        from repro_torch.engine import MinibatchEngine
        from repro_torch.train import adam_init, step_program

        tds, tcfg, tc = train
        engine = MinibatchEngine.from_config(tds.graph, tc.engine_config(tcfg.num_layers),
                                             dataset=tds, device=device)
        model = init_gnn(tcfg, seed=SEED, device=device)
        prog = step_program(engine, tcfg, model, adam_init(model),
                            torch.as_tensor(tds.labels, device=dev), tc.lr)
        float(prog(tc.local_batch, engine.step_state(0))[0])  # warm-up + capture
        _, step = record_call(dev, prog, tc.local_batch, engine.step_state(1))
        print(f"phase10b train step ({tcfg.model}, {tc.mode}, captured {prog.capture}): one "
              f"replay {step.syncs} syncs dispatched / {step.sync_warnings} sync-debug warnings "
              f"({len(step.ops)} ops; sites {step.sites})")
        if device == "cuda":  # the CPU's plain spmm reads its row counts
            check(step.syncs == 0 and step.sync_warnings == 0,
                  f"phase10b: the train step syncs {step.syncs} / {step.sync_warnings}")
        analysis_shard_step(dev, tds, tcfg, tc)
    analysis_lm_step(dev)
    return launches


def analysis_shard_step(dev, tds, gnn_cfg, tc) -> None:
    """10b: one replay of the shard executor's plan program and of its
    step program, on a one-rank group in this process (NCCL on a card,
    gloo on the CPU; a FileStore in a temporary directory), under the trace
    pass: no host sync on a card.  The programs go before the group."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.analysis.trace import record_call
    from repro_torch.engine import MinibatchEngine
    from repro_torch.models.gnn import init_gnn
    from repro_torch.train import adam_init, step_program

    backend = "nccl" if dev.type == "cuda" else "gloo"
    stc = dataclasses.replace(tc, executor="shard", num_pes=1)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            engine = MinibatchEngine.from_config(tds.graph, stc.engine_config(gnn_cfg.num_layers),
                                                 dataset=tds, device=dev)
            runner = engine.shard_runner
            runner.plan_at(0)  # warm-up + capture
            _, plan = record_call(dev, runner.plan_at, 1)
            model = init_gnn(gnn_cfg, seed=SEED, device=dev)
            prog = step_program(engine, gnn_cfg, model, adam_init(model),
                                torch.as_tensor(tds.labels, device=dev), stc.lr)
            float(prog(stc.local_batch, engine.step_state(0))[0])  # warm-up + capture
            _, step = record_call(dev, prog, stc.local_batch, engine.step_state(1))
            print(f"phase10b shard executor ({backend}, 1 rank; captured {prog.capture}): one "
                  f"plan_at replay {plan.syncs} syncs dispatched / {plan.sync_warnings} sync-debug "
                  f"warnings ({len(plan.ops)} ops); one train step replay {step.syncs} / "
                  f"{step.sync_warnings} ({len(step.ops)} ops; sites {step.sites})")
            if dev.type == "cuda":
                check(prog.capture and runner.plan_program.capture,
                      "phase10b: the shard programs did not capture under NCCL")
                check(plan.syncs == plan.sync_warnings == step.syncs == step.sync_warnings == 0,
                      f"phase10b: the shard programs sync: plan {plan.sites}, step {step.sites}")
            del prog, runner, engine
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()


def analysis_lm_step(dev) -> None:
    """10b: one replay of ``make_train_step``'s program (a reduced gemma2,
    batch 4 x S 64) under the trace pass: no host sync on a card."""
    import numpy as np
    from repro_torch.analysis.trace import record_call
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import adam_init

    cfg = get_config("gemma2-2b").reduced()
    model = init_lm(cfg, seed=SEED, device=dev)
    opt, step = adam_init(model), make_train_step(cfg, lr=1e-3)
    batch = on(lm_train_batch(cfg, np.random.default_rng(SEED), LM_BATCH, LM_TRAIN_CHECK_S), dev)
    float(step(model, opt, batch)[2]["loss"])  # warm-up + capture
    _, rec = record_call(dev, step, model, opt, batch)
    prog = step.program(model)
    print(f"phase10b LM train step ({cfg.name}, B {LM_BATCH} x S {LM_TRAIN_CHECK_S}; captured "
          f"{prog.capture}): one replay {rec.syncs} syncs dispatched / {rec.sync_warnings} "
          f"sync-debug warnings ({len(rec.ops)} ops; sites {rec.sites})")
    if dev.type == "cuda":
        check(prog.capture and rec.syncs == rec.sync_warnings == 0,
              f"phase10b: the LM train step syncs {rec.syncs} / {rec.sync_warnings}")


# --------------------------------------------------------------------------
# phase 11
# --------------------------------------------------------------------------
def lm_leaves(state: dict) -> list:
    """A decode state's tensors: ``pos``, then each layer's caches."""
    out = [state["pos"]]
    for layer in state["layers"]:
        for part in sorted(layer):
            out += [layer[part][k] for k in sorted(layer[part])]
    return out


def lm_greedy(serve, model, logits, state, n: int, step_ms: list = None):
    """``n`` greedy tokens (B, n) after ``logits``; with ``step_ms`` each
    serve step is timed on the host clock, ended by a device sync."""
    import numpy as np
    import torch

    out = []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for _ in range(n):
        out.append(tok[:, 0].cpu().numpy())
        if step_ms is not None:
            sync(tok.device)
            t0 = time.perf_counter()
        logits, state = serve(model, state, tok)
        if step_ms is not None:
            sync(tok.device)
            step_ms.append(1e3 * (time.perf_counter() - t0))
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    return np.stack(out, 1), state


def free_cached(dev) -> None:
    """Collect dead objects (a captured program's graph among them) and, on
    a card, return the cached blocks to the device for the next model."""
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_inputs(cfg, rng, seq: int) -> tuple:
    """Seeded numpy tokens (B, seq - prefix), prefix embeddings and, for
    whisper, encoder frames."""
    import numpy as np

    toks = rng.integers(0, cfg.vocab_size, (LM_BATCH, seq - cfg.num_prefix_tokens))
    prefix = (rng.standard_normal((LM_BATCH, cfg.num_prefix_tokens, cfg.d_model))
              .astype(np.float32) if cfg.num_prefix_tokens else None)
    enc = (rng.standard_normal((LM_BATCH, cfg.enc_len, cfg.d_model)).astype(np.float32)
           if cfg.enc_dec else None)
    return toks.astype(np.int32), prefix, enc


def lm_run(model, cfg, dev, toks, prefix, enc) -> dict:
    """``forward_train`` and ``prefill_decode`` plus ``LM_GREEDY`` tokens on
    ``dev``, results on the CPU."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import forward_train, init_decode_state, prefill_decode

    t = lambda x: None if x is None else torch.as_tensor(x, device=dev)  # noqa: E731
    with torch.inference_mode():
        logits, _ = forward_train(model, cfg, t(toks), t(prefix), t(enc))
    state = init_decode_state(cfg, LM_BATCH, LM_PROMPT + LM_GREEDY, device=dev)
    if cfg.enc_dec:
        state["enc_out"] = t(enc)
    last, state = prefill_decode(model, cfg, state, t(toks[:, :LM_PROMPT]))
    leaves = [x.to("cpu", copy=True) for x in lm_leaves(state)]  # decoding updates in place
    tokens, _ = lm_greedy(make_serve_step(cfg), model, last, state, LM_GREEDY)
    return {"train": logits.cpu(), "last": last.cpu(), "leaves": leaves, "tokens": tokens}


def lm_compare(tag: str, card: dict, cpu: dict) -> str:
    """Card against CPU: logits and caches within ``ATOL``, ``pos`` and the
    greedy tokens equal."""
    import numpy as np

    errs = {k: float((card[k] - cpu[k]).abs().max()) for k in ("train", "last")}
    errs["caches"] = max(float((a.double() - b.double()).abs().max())
                         for a, b in zip(card["leaves"][1:], cpu["leaves"][1:]))
    check(all(v <= ATOL for v in errs.values()), f"{tag}: card vs cpu {errs} (atol {ATOL})")
    check(int(card["leaves"][0]) == int(cpu["leaves"][0]) == LM_PROMPT, f"{tag}: pos differs")
    check(np.array_equal(card["tokens"], cpu["tokens"]),
          f"{tag}: greedy tokens card {card['tokens'].tolist()} cpu {cpu['tokens'].tolist()}")
    return (f"forward_train {errs['train']:.3e}, prefill_decode logits {errs['last']:.3e}, "
            f"caches {errs['caches']:.3e}; pos {LM_PROMPT} and {LM_GREEDY} greedy tokens equal")


def phase_lm_archs(dev) -> None:
    """11a: the ten architectures, reduced, card against CPU."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.transformer.moe import route

    for arch in ALL_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        model = init_lm(cfg, seed=SEED, device=dev)
        cpu_model = copy.deepcopy(model).to("cpu")
        drawn = dict(init_lm(cfg, seed=SEED, device="cpu").named_parameters())
        check(all(torch.equal(p.detach().cpu().view(torch.int32), drawn[n].detach().view(
            torch.int32)) for n, p in model.named_parameters()),
            f"phase11a {arch}: init_lm on the card differs from the CPU's draw")
        rng = np.random.default_rng(SEED)
        inputs = lm_inputs(cfg, rng, LM_PROMPT + 16)
        line = lm_compare(f"phase11a {arch}", lm_run(model, cfg, dev, *inputs),
                          lm_run(cpu_model, cfg, torch.device("cpu"), *inputs))
        if cfg.num_experts:
            x = rng.standard_normal((LM_BATCH * LM_PROMPT, cfg.d_model)).astype(np.float32)
            a = route(model.layers[0]["moe"], cfg, torch.as_tensor(x, device=dev))
            b = route(cpu_model.layers[0]["moe"], cfg, torch.from_numpy(x))
            check(torch.equal(a.expert.cpu(), b.expert) and torch.equal(a.table_tok.cpu(),
                                                                        b.table_tok),
                  f"phase11a {arch}: MoE routes differ card vs cpu")
            line += f"; routes equal ({int((b.table_tok >= 0).sum())} of {b.table_tok.numel()} " \
                    "expert slots filled)"
        print(f"phase11a {arch}: init_lm bits equal to the CPU's; {line} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_lm(card: str, device: str = "cuda", cfg=None, prefill_s: int = LM_PREFILL_S) -> dict:
    """Phase 11: 11a, then 11b on ``cfg`` (gemma2-2b at its published
    size unless given); returns the kernel launches of the run (the LM
    path launches none of the seven).  ``device="cpu"`` with a small
    ``cfg`` rehearses the phase with no card."""
    import copy
    import dataclasses as dc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.trace import record_call
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import (
        decode_program,
        forward_decode,
        forward_train,
        init_decode_state,
        init_lm,
        prefill_decode,
    )

    dev = torch.device(device)
    reset_launches()
    t_start = time.perf_counter()
    phase_lm_archs(dev)
    print(f"phase11a: {time.perf_counter() - t_start:.1f} s", flush=True)

    # 11b: the published widths and depth
    cfg = cfg or get_config("gemma2-2b")
    B, S0 = LM_BATCH, LM_PROMPT
    base_mb = torch.cuda.memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=SEED, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    print(f"phase11b {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters, {n_bytes} bytes; init_lm "
          f"on {device} {init_s:.1f} s; [{card}]", flush=True)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S0)), dtype=torch.int32,
                              device=dev)
    serve = make_serve_step(cfg)
    max_len = S0 + LM_NEW
    prefill_decode(model, cfg, init_decode_state(cfg, B, max_len, device=dev), prompts)
    sync(dev)  # warm-up: cuBLAS handles and algorithms
    state_a = init_decode_state(cfg, B, max_len, device=dev)
    t0 = time.perf_counter()
    logits_a, state_a = prefill_decode(model, cfg, state_a, prompts)
    sync(dev)
    prefill_decode_ms = 1e3 * (time.perf_counter() - t0)
    state_b = init_decode_state(cfg, B, max_len, device=dev)
    for t in range(S0):
        logits_b, state_b = serve(model, state_b, prompts[:, t:t + 1])
    check(torch.equal(logits_a, logits_b), "phase11b: prefill_decode logits != stepped logits")
    leaves_a, leaves_b = lm_leaves(state_a), lm_leaves(state_b)
    check(all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b, strict=True)),
          "phase11b: prefill_decode caches != stepped caches")
    eager_state = copy.deepcopy(state_b)
    step_ms: list = []
    gen_a, state_a = lm_greedy(serve, model, logits_a, state_a, LM_NEW, step_ms)
    gen_b, _ = lm_greedy(serve, model, logits_b, state_b, LM_NEW)
    check(np.array_equal(gen_a, gen_b), "phase11b: greedy tokens after prefill != stepped")
    decode_ms = float(np.median(step_ms))
    # the captured step against forward_decode run eagerly from the same state
    eager_ms: list = []
    eager_step = lambda m, st, tok: forward_decode(m, cfg, st, tok)  # noqa: E731
    gen_e, _ = lm_greedy(eager_step, model, logits_b, eager_state, LM_NEW, eager_ms)
    check(np.array_equal(gen_e, gen_b), "phase11b: greedy tokens captured != eager")
    prog = decode_program(model, cfg)
    key = (B, max_len)
    check(dev.type != "cuda" or (prog.capture and prog.compiles == {key: 1}),
          f"phase11b: decode program compiles {prog.compiles}")
    print(f"phase11b decode program (captured {prog.capture}): compiles {prog.compiles}, "
          f"captures a key {prog.captures} (one a decode state); per key, its first capture: "
          + "; ".join(f"{k}: {r['capture_ms']:.1f} ms, {r['pool_bytes']} B"
                      for k, r in prog.report().items())
          + f"; {LM_NEW} greedy tokens equal to forward_decode run eagerly; eager ms a step "
          f"median {float(np.median(eager_ms)) if eager_ms else 0.0:.3f}; [{card}]", flush=True)
    print(f"phase11b prefill_decode (B {B}, prompt {S0}) bit for bit equal to {S0} "
          f"make_serve_step steps: logits, {len(leaves_a)} state tensors, {LM_NEW} greedy "
          f"tokens (row 0: {gen_a[0][:8].tolist()} ...); [{card}]", flush=True)
    print(f"phase11b decode ms a step (median of {LM_NEW}, each ended by a sync) "
          f"{decode_ms:.3f} [min {min(step_ms):.3f}, max {max(step_ms):.3f}], "
          f"{B / decode_ms * 1e3:.1f} tokens/s; memory bound {bound_ms:.3f} ms "
          f"({n_bytes} bytes / {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"{bound_ms / decode_ms:.4f} of it; prefill_decode {prefill_decode_ms:.1f} ms "
          f"({prefill_decode_ms / S0:.3f} a token step); [{card}]", flush=True)

    # teacher-forced logits against stepped decode
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, LM_TRAIN_S)), device=dev)
    with torch.inference_mode():
        logits, _ = forward_train(model, cfg, toks)
    state = init_decode_state(cfg, B, LM_TRAIN_S, device=dev)
    err = 0.0
    for t in range(LM_TRAIN_S):
        lg, state = serve(model, state, toks[:, t:t + 1])
        err = max(err, float((logits[:, t] - lg).abs().max()))
    scale = float(logits.abs().max())
    print(f"phase11b forward_train (S {LM_TRAIN_S}) vs stepped decode: max abs diff "
          f"{err:.3e}, max |logit| {scale:.3f}, bound {LM_CONSISTENCY * scale:.3e}", flush=True)
    check(err <= LM_CONSISTENCY * scale, f"phase11b: train/decode differ by {err}")
    del logits, state

    # the full-sequence prefill step (flash path)
    prefill = make_prefill_step(cfg)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, prefill_s)),
                                       device=dev)}
    out = prefill(model, batch)
    sync(dev)
    check(out.shape == (B, cfg.vocab_size) and bool(torch.isfinite(out).all()),
          "phase11b: make_prefill_step gave non-finite or misshaped logits")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(model, batch)
        sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    del batch, out
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0
    print(f"phase11b make_prefill_step (B {B}, S {prefill_s}) ms {min(times):.1f} (3 calls: "
          + ", ".join(f"{v:.1f}" for v in times) + f"); peak memory {peak / 1024:.3f} GiB "
          f"allocated ({base_mb / 1024:.3f} GiB of it held by earlier phases); [{card}]",
          flush=True)

    # one decode step under the profiler and the trace pass
    tok = torch.argmax(logits_b, -1)[:, None].to(torch.int32)
    if dev.type == "cuda":
        steps = 5
        for _ in range(2):  # the first trace pays the tracer's start-up
            sync(dev)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    serve(model, state_b, tok)
                sync(dev)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        stats = cuda_kernel_us(prof)
        busy_ms = sum(us for us, _, _ in stats) / 1e3 / steps
        launches = sum(c for _, c, _ in stats) / steps
        print(f"phase11b profile, {steps} decode steps (CUDA tracing on): wall "
              f"{wall_ms / steps:.3f} ms a step, device busy {busy_ms:.3f} ms, idle share "
              f"{1 - busy_ms * steps / wall_ms:.4f} ({1 - busy_ms / decode_ms:.4f} against the "
              f"untraced median step), {launches:.0f} CUDA kernels a step; [{card}]")
        for us, count, key in stats[:8]:
            print(f"  device {us / 1e3 / steps:9.4f} ms a step  calls {count / steps:6.1f}  "
                  f"{key[:90]}")
    _, rec = record_call(dev, serve, model, state_b, tok)
    print(f"phase11b one decode step, trace pass: {rec.syncs} syncs dispatched / "
          f"{rec.sync_warnings} sync-debug warnings, {len(rec.ops)} ops; sites {rec.sites}",
          flush=True)
    del model, state_a, state_b, logits_a, logits_b

    # card against CPU at the published widths, 2 layers
    small = dc.replace(cfg, num_layers=2)
    model = init_lm(small, seed=SEED, device=dev)
    cpu_model = copy.deepcopy(model).to("cpu")
    inputs = lm_inputs(small, rng, S0 + 16)
    line = lm_compare(f"phase11b {small.name} at 2 layers",
                      lm_run(model, small, dev, *inputs),
                      lm_run(cpu_model, small, torch.device("cpu"), *inputs))
    print(f"phase11b {small.name} at 2 layers, card vs cpu: {line}", flush=True)
    del model, cpu_model
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    print(f"phase11: {time.perf_counter() - t_start:.1f} s; launches of the seven kernels "
          f"{launches}", flush=True)
    return launches


# --------------------------------------------------------------------------
# phase 12
# --------------------------------------------------------------------------
def lm_train_batch(cfg, rng, batch: int, seq: int) -> dict:
    """Seeded numpy inputs of a train step: tokens and labels (batch, seq -
    prefix), prefix embeddings and, for whisper, encoder frames."""
    import numpy as np

    s_text = seq - cfg.num_prefix_tokens
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, s_text)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, s_text)).astype(np.int32)}
    if cfg.num_prefix_tokens:
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["enc_out"] = rng.standard_normal((batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


def on(batch: dict, dev) -> dict:
    import torch

    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def lm_grads(cfg, model, batch: dict) -> tuple:
    """``lm_loss`` and every parameter's gradient, on the model's device;
    results on the CPU."""
    import torch
    from repro_torch.launch.steps import lm_loss

    params = list(model.parameters())
    loss = lm_loss(cfg, model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), [g.cpu() for g in grads]


def lm_grads_close(tag: str, model, got: list, want: list) -> str:
    """Each parameter's gradient ``got`` within ``GRAD_RTOL`` of its
    largest ``|g|`` in ``want`` (the SSD's ``A_log``: ``SSD_DECAY_RTOL``)."""
    worst, where = 0.0, ""
    for (name, _), a, b in zip(model.named_parameters(), got, want, strict=True):
        rtol = SSD_DECAY_RTOL if name.endswith("ssm.A_log") else GRAD_RTOL
        scale = float(b.abs().max())
        gap = float((a - b).abs().max())
        check(gap <= rtol * scale, f"{tag}: step-0 gradient {name}: max abs diff {gap:.3e} > "
              f"{rtol} x its largest |g| {scale:.3e}")
        if scale and gap / scale >= worst:
            worst, where = gap / scale, name
    return (f"gradients within {worst:.3e} of each parameter's largest |g| (worst {where}; "
            f"bound {GRAD_RTOL}, A_log {SSD_DECAY_RTOL}) over {len(want)} parameters")


def lm_grads_compare(tag: str, cfg, card, cpu, batch: dict) -> str:
    """``lm_loss`` card against CPU within ``LM_LOSS_RTOL``, and the
    gradients by :func:`lm_grads_close`."""
    dev = next(card.parameters()).device
    l_card, g_card = lm_grads(cfg, card, on(batch, dev))
    l_cpu, g_cpu = lm_grads(cfg, cpu, on(batch, "cpu"))
    check(abs(l_card - l_cpu) <= LM_LOSS_RTOL * abs(l_cpu),
          f"{tag}: lm_loss card {l_card!r} cpu {l_cpu!r} (rtol {LM_LOSS_RTOL})")
    return (f"lm_loss card {l_card:.6f} cpu {l_cpu:.6f}; "
            + lm_grads_close(tag, cpu, g_card, g_cpu))


def lm_steps(cfg, model, batch: dict, steps: int, eager: bool = False) -> tuple:
    """The losses of ``steps`` ``make_train_step`` steps on one batch, and
    the step's program; ``eager`` runs the program's body as it is (on a
    card the step replays one captured graph)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import adam_init

    step, opt, out = make_train_step(cfg, lr=1e-3), adam_init(model), []
    prog = step.program(model)
    for _ in range(steps):
        if eager:
            loss = prog.fn(list(model.parameters()), opt, batch)
        else:
            model, opt, m = step(model, opt, batch)
            loss = m["loss"]
        out.append(float(loss))
    return out, prog


def lm_captured_vs_eager(tag: str, cfg, model, batch: dict, steps: int) -> tuple:
    """``steps`` steps of ``make_train_step``'s program (captured on a card)
    from ``model``'s weights against its body run eagerly from a copy:
    losses within ``TRAIN_RTOL`` (cuBLAS may take another algorithm inside
    a graph), one capture on a card.  ``model`` is trained in place.
    Returns the captured losses and a line to print."""
    import copy

    eager_model = copy.deepcopy(model)
    a, prog = lm_steps(cfg, model, batch, steps)
    e, _ = lm_steps(cfg, eager_model, batch, steps, eager=True)
    err = max(abs(x - y) / abs(y) for x, y in zip(a, e))
    gap = max(float((p.detach() - q.detach()).abs().max())
              for p, q in zip(model.parameters(), eager_model.parameters()))
    check(err <= TRAIN_RTOL, f"{tag}: captured losses {a}, eager {e} (rtol {TRAIN_RTOL})")
    if next(model.parameters()).is_cuda:
        check(prog.capture and list(prog.captures.values()) == [1]
              and list(prog.compiles.values()) == [1],
              f"{tag}: the train program's captures {prog.captures}, compiles {prog.compiles}")
    del eager_model
    return a, (f"{steps} steps through the program (captured {prog.capture}, "
               f"{sum(prog.captures.values())} capture) within {err:.3e} of its body run eagerly "
               f"(rtol {TRAIN_RTOL}; bit-equal {a == e}), final weights max abs diff {gap:.3e}")


def coop_route_syncs(dev, model, cfg, tokens) -> tuple:
    """Host syncs (dispatched, sync-debug warnings) of the cooperative
    embedding's forward and backward, and of ``torch.unique`` on the same
    ids (the dedup the route replaced), by the analyzer's trace pass."""
    import torch
    from repro_torch.analysis.trace import record_call
    from repro_torch.models.transformer.model import _embed_tokens

    def route():
        h = _embed_tokens(model, cfg, tokens)
        return torch.autograd.grad(h.sum(), [model.embed])[0]

    _, rec = record_call(dev, route)
    _, old = record_call(dev, lambda: torch.unique(tokens.reshape(-1)))
    return rec, old


def phase_lm_train_archs(dev) -> None:
    """12a: the ten architectures, reduced, card against CPU; then the
    cooperative embedding on one of them."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.transformer.model import _embed_tokens

    for arch in ALL_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        model = init_lm(cfg, seed=SEED, device=dev)
        cpu_model = copy.deepcopy(model).to("cpu")
        batch = lm_train_batch(cfg, np.random.default_rng(SEED), LM_BATCH, LM_TRAIN_CHECK_S)
        line = lm_grads_compare(f"phase12a {arch}", cfg, model, cpu_model, batch)
        a, against = lm_captured_vs_eager(f"phase12a {arch}", cfg, model, on(batch, dev),
                                          LM_TRAIN_STEPS)
        b, _ = lm_steps(cfg, cpu_model, on(batch, "cpu"), LM_TRAIN_STEPS)
        err = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        check(err <= TRAIN_RTOL and a[-1] < a[0],
              f"phase12a {arch}: losses card {a} cpu {b} (rtol {TRAIN_RTOL}, falling)")
        print(f"phase12a {arch}: {line}; {LM_TRAIN_STEPS} steps' losses card "
              f"{[round(v, 6) for v in a]} within {err:.3e} of the cpu's (rtol {TRAIN_RTOL}), "
              f"falling; card {against} ({time.perf_counter() - t0:.1f} s)", flush=True)

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), cooperative_embed=True)
    toks = synthetic_token_batch(LM_BATCH, COOP_CHECK_S + 1, cfg.vocab_size, seed=SEED)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    check(batch["tokens"].size > cfg.vocab_size, "phase12a: B*S must exceed V")
    model = init_lm(cfg, seed=SEED, device=dev)
    cpu_model = copy.deepcopy(model).to("cpu")
    x = torch.as_tensor(batch["tokens"])
    h_card = _embed_tokens(model, cfg, x.to(dev))
    h_cpu = _embed_tokens(cpu_model, cfg, x)
    check(torch.equal(h_card.cpu(), h_cpu) and torch.equal(h_cpu, cpu_model.embed[x]),
          "phase12a cooperative embedding: h differs card vs cpu or from embed[tokens]")
    line = lm_grads_compare("phase12a cooperative embedding", cfg, model, cpu_model, batch)
    rec, old = coop_route_syncs(dev, model, cfg, x.to(dev))
    check(rec.syncs == 0 and not rec.sync_warnings,
          f"phase12a cooperative embedding: the route syncs: {rec.sites}")
    print(f"phase12a cooperative embedding ({cfg.name}, B {LM_BATCH} x S {COOP_CHECK_S} = "
          f"{x.numel()} token slots > V {cfg.vocab_size}): h card (kernels) equal bit for bit "
          f"to the cpu's (plain versions) and to embed[tokens]; {line}; host syncs of the "
          f"route (forward and backward) {rec.syncs} dispatched / {rec.sync_warnings} "
          f"sync-debug warnings, of torch.unique on the same ids {old.syncs} / "
          f"{old.sync_warnings}", flush=True)


def phase_lm_train(card: str, device: str = "cuda", cfg=None, seq: int = LM_TRAIN_SEQ,
                   coop_cfg=None, coop_shape: tuple = (COOP_B, COOP_S)) -> dict:
    """Phase 12: 12a, 12b on ``cfg`` (gemma2-2b at its published size
    unless given) at batch ``LM_TRAIN_B`` and ``seq``, 12c on ``coop_cfg``
    (whisper-tiny at its published size unless given) at ``coop_shape``
    (batch, sequence).  Returns 12c's train step's launches of the seven
    kernels and, on a card, the phase-1 rows of the cooperative
    embedding's kernels.  ``device="cpu"`` with small configs and shapes rehearses the
    phase with no card."""
    import copy

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.trace import record_call
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.launch.steps import lm_loss, make_train_step
    from repro_torch.models.transformer import active_param_count, init_lm
    from repro_torch.train import adam_init, adam_update

    dev = torch.device(device)
    card_run = dev.type == "cuda"
    if card_run:
        torch.cuda.empty_cache()  # what earlier phases cached, for 12b's ~55 GB
    t_start = time.perf_counter()
    phase_lm_train_archs(dev)
    print(f"phase12a: {time.perf_counter() - t_start:.1f} s", flush=True)

    # 12b: the published widths and depth
    cfg = cfg or get_config("gemma2-2b")
    B, S = LM_TRAIN_B, seq
    spec = ShapeSpec("phase12", S, B, "train")
    base = torch.cuda.memory_allocated(dev) / 2**30 if card_run else 0.0
    if card_run:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=SEED, device=dev)
    opt = adam_init(model)
    sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase12b {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}: {n_params} parameters; init_lm "
          f"and adam_init on {device} {time.perf_counter() - t0:.1f} s; [{card}]", flush=True)
    toks = synthetic_token_batch(B, S + 1, cfg.vocab_size, seed=SEED)
    batch = on({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, dev)
    step = make_train_step(cfg, lr=1e-3)
    prog = step.program(model)
    eager = lambda: prog.fn(list(model.parameters()), opt, batch)  # noqa: E731
    # the eager step first: the peak (phase 13b's), FLOPs and the split,
    # before the capture's pool holds memory of its own
    t0 = time.perf_counter()
    losses = [float(eager())]  # warm-up: cuBLAS handles and algorithms
    warm_ms = 1e3 * (time.perf_counter() - t0)
    sync(dev)
    t0 = time.perf_counter()
    losses.append(float(eager()))
    eager_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if card_run else 0.0
    # one step under PyTorch's FLOP counter, for phase 13b's traced count
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        eager()
        sync(dev)
    counted_flops = fc.get_total_flops()
    print(f"phase12b the eager step (the program's body): warm-up {warm_ms:.1f} ms, then "
          f"{eager_ms:.1f} ms (ended by the loss's read); peak memory {peak:.3f} GiB allocated "
          f"({base:.3f} GiB of it held by earlier phases); one step under FlopCounterMode: "
          f"{counted_flops:.6e} FLOPs; [{card}]", flush=True)
    # one step split into its stages, each ended by a sync
    params = list(model.parameters())
    marks = [time.perf_counter()]
    loss = lm_loss(cfg, model, batch)
    sync(dev)
    marks.append(time.perf_counter())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    sync(dev)
    marks.append(time.perf_counter())
    opt = adam_update(params, grads, opt, lr=1e-3)
    sync(dev)
    marks.append(time.perf_counter())
    del loss, grads, params
    split = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    print(f"phase12b one eager step split (each stage ended by a sync): forward (lm_loss) "
          f"{split[0]:.1f} ms, backward (remat recomputes included) {split[1]:.1f} ms, "
          f"adam_update {split[2]:.1f} ms; [{card}]", flush=True)
    # the program: the eager warm-up and the capture, then replays
    if card_run:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    model, opt, m = step(model, opt, batch)
    losses.append(float(m["loss"]))
    first_ms = 1e3 * (time.perf_counter() - t0)
    step_ms = []
    for _ in range(LM_TRAIN_TIMED):
        sync(dev)
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    check(all(np.isfinite(losses)), f"phase12b: losses {losses}")
    step_s = float(np.median(step_ms)) / 1e3
    flops = model_flops(cfg, spec, active_param_count(cfg))
    cap_peak = torch.cuda.max_memory_allocated(dev) / 2**30 if card_run else 0.0
    rep = next(iter(prog.report().values()), None)
    if card_run:
        check(rep is not None and list(prog.captures.values()) == [1],
              f"phase12b: the train program's captures {prog.captures}")
    print(f"phase12b make_train_step (B {B}, S {S}), captured {prog.capture}: first call "
          f"(eager warm-up + capture) {first_ms:.1f} ms"
          + (f", of it capture {rep['capture_ms']:.1f} ms, pool grown {rep['pool_bytes']} B, "
             f"{sum(rep['launches'].values())} launches of the seven kernels a replay"
             if rep else "")
          + "; replayed step ms (to the loss's read) " + ", ".join(f"{v:.1f}" for v in step_ms)
          + f", median {1e3 * step_s:.1f} (eager {eager_ms:.1f}); {B * S / step_s:.1f} tokens/s; "
          f"model_flops {flops:.4e} (6 N D, N = active_param_count {active_param_count(cfg)}), "
          f"{flops / step_s / PEAK_FLOPS:.4f} of {PEAK_FLOPS / 1e12:.0f} TFLOP/s float32; "
          f"losses {[round(v, 6) for v in losses]}; peak memory with the graph's pool "
          f"{cap_peak:.3f} GiB allocated; [{card}]", flush=True)
    if card_run:
        for _ in range(2):  # the first trace pays the tracer's start-up
            sync(dev)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model, opt, m = step(model, opt, batch)
                sync(dev)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        stats = cuda_kernel_us(prof)
        busy_ms = sum(us for us, _, _ in stats) / 1e3
        gemm = [(us, c) for us, c, key in stats if "gemm" in key.lower()]
        print(f"phase12b profile, one replayed step (CUDA tracing on): wall {wall_ms:.1f} ms (the "
              f"tracer's cost included), device busy {busy_ms:.1f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.4f}; the untraced median step {1e3 * step_s:.1f} ms, "
              f"{sum(c for _, c, _ in stats)} CUDA kernels, of them float32 GEMMs "
              f"{sum(us for us, _ in gemm) / 1e3:.1f} ms over {sum(c for _, c in gemm)}; "
              f"[{card}]")
        for us, count, key in stats[:10]:
            print(f"  device {us / 1e3:10.3f} ms  calls {count:6d}  {key[:90]}")
        rec = record_call(dev, step, model, opt, batch)[1]
        print(f"phase12b one replayed train step, trace pass: {rec.syncs} syncs dispatched / "
              f"{rec.sync_warnings} sync-debug warnings, {len(rec.ops)} ops; sites "
              f"{rec.sites}", flush=True)
        check(rec.syncs == rec.sync_warnings == 0, f"phase12b: the replay syncs: {rec.sites}")
    del model, opt, batch, m, prog, eager, step
    free_cached(dev)

    # captured against eager at the published widths, 2 layers, B x S as above
    small = dataclasses.replace(cfg, num_layers=2)
    model = init_lm(small, seed=SEED, device=dev)
    batch = on(lm_train_batch(small, np.random.default_rng(SEED), B, S), dev)
    held = torch.cuda.memory_allocated(dev) / 2**30 if card_run else 0.0
    _, line = lm_captured_vs_eager(f"phase12b {small.name} at 2 layers", small, model, batch,
                                   LM_TRAIN_STEPS)
    print(f"phase12b {small.name} at 2 layers, B {B} x S {S} ({held:.3f} GiB allocated "
          f"before its model): {line}; [{card}]", flush=True)
    del model, batch
    free_cached(dev)

    # card against CPU at the published widths, 2 layers
    small = dataclasses.replace(cfg, num_layers=2)
    model = init_lm(small, seed=SEED, device=dev)
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = lm_train_batch(small, np.random.default_rng(SEED), LM_BATCH, LM_TRAIN_CHECK_S)
    line = lm_grads_compare(f"phase12b {small.name} at 2 layers", small, model, cpu_model,
                            batch)
    print(f"phase12b {small.name} at 2 layers, S {LM_TRAIN_CHECK_S}, card vs cpu: {line}",
          flush=True)
    del model, cpu_model
    rows = phase_coop_embed(card, dev, coop_cfg or get_config("whisper-tiny"), *coop_shape)
    launches = rows.pop("launches")
    print(f"phase12: {time.perf_counter() - t_start:.1f} s; 12c's train step's launches of "
          f"the seven kernels {launches}", flush=True)
    return {"launches": launches, "rows": rows, "measured": {
        "flops": counted_flops, "peak_gib": peak, "base_gib": base, "step_ms": 1e3 * step_s,
        "batch": B, "seq": S}}


def phase_coop_embed(card: str, dev, cfg, batch: int, seq: int) -> dict:
    """12c: ``cfg`` (whisper-tiny) with the cooperative embedding,
    ``batch`` x ``seq`` Zipf tokens: the kernel route's rows
    bit for bit equal to the plain versions' (on the same device) and to
    ``embed[tokens]``; loss and gradients against the plain
    ``embed[tokens]`` route; one train step, with the launch counts zeroed
    right before it and read right after (on a card exactly
    ``COOP_STEP_LAUNCHES``).  Returns that step's launches and, on a card,
    the phase-1 rows of ``unique_compact`` and both ``gather`` calls at
    this path's shapes."""
    import copy

    import torch
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gather import gather, gather_ref
    from repro_torch.kernels.unique_compact import unique_with_inverse, unique_with_inverse_ref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.transformer.model import _embed_tokens
    from repro_torch.train import adam_init

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, cooperative_embed=True)
    V = cfg.vocab_size
    toks = synthetic_token_batch(batch, seq + 1, V, seed=SEED)
    data = on({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, dev)
    data["enc_out"] = torch.zeros((batch, cfg.enc_len, cfg.d_model), device=dev)
    x = data["tokens"]
    check(x.numel() > V, "phase12c: B*S must exceed V")
    model = init_lm(cfg, seed=SEED, device=dev)
    ids = x.reshape(-1).to(torch.int32).contiguous()
    uniq_r, inv_r = unique_with_inverse_ref(ids, V)
    # detached: a live autograd graph over the weights, made on this stream,
    # would break the train step's capture below
    h = _embed_tokens(model, cfg, x).detach()
    h_plain = gather_ref(gather_ref(model.embed.detach(), uniq_r), inv_r).reshape(h.shape)
    check(torch.equal(h, h_plain) and torch.equal(h, model.embed[x]),
          "phase12c: the kernel route's rows differ from the plain versions' or embed[tokens]")
    distinct = int((uniq_r != 0x7FFFFFFF).sum())
    # the same weights through the plain embed[tokens] route
    l_coop, g_coop = lm_grads(cfg, model, data)
    l_plain, g_plain = lm_grads(dataclasses.replace(cfg, cooperative_embed=False),
                                copy.deepcopy(model), data)
    check(abs(l_coop - l_plain) <= LM_LOSS_RTOL * abs(l_plain),
          f"phase12c: lm_loss {l_coop!r}, plain route {l_plain!r}")
    line = (f"lm_loss {l_coop:.6f} against the plain route's {l_plain:.6f}; "
            + lm_grads_close("phase12c", model, g_coop, g_plain))
    step, opt = make_train_step(cfg, lr=1e-3), adam_init(model)
    _, _, m = step(model, opt, data)  # on a card the eager warm-up, then the capture
    reset_launches()
    _, _, m = step(model, opt, data)
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    check(bool(torch.isfinite(m["loss"])), "phase12c: non-finite loss")
    prog = step.program(model)
    rep = next(iter(prog.report().values()), None)
    if dev.type == "cuda":
        want = {k: COOP_STEP_LAUNCHES.get(k, 0) for k in KERNELS}
        check(launches == want, f"phase12c: the train step launched {launches}, not {want}")
        check(rep is not None and list(prog.captures.values()) == [1],
              f"phase12c: the train program's captures {prog.captures}")
    print(f"phase12c {cfg.name} (d {cfg.d_model}, {cfg.num_layers} layers, V {V}, enc_len "
          f"{cfg.enc_len}) cooperative embedding at B {batch} x S {seq}: {distinct} "
          f"distinct ids of {x.numel()} token slots ({x.numel() / distinct:.2f} slots a row "
          f"read); h equal bit for bit to the plain versions' and to embed[tokens]; {line}; "
          f"the second make_train_step call (a replay where captured: {prog.capture}) loss "
          f"{float(m['loss']):.6f}, launches {launches}"
          + (f"; capture {rep['capture_ms']:.1f} ms, pool grown {rep['pool_bytes']} B" if rep
             else "") + f" ({time.perf_counter() - t0:.1f} s); [{card}]", flush=True)
    out = {"launches": launches}
    if dev.type == "cuda":
        path, per = ["lm_train"], "1/step"
        table = model.embed.detach()
        uniq, inv = unique_with_inverse(ids, V)
        rows = gather(table, uniq)
        rows_out = {}
        add_row(rows_out, "unique_compact", shared_row(
            "unique_compact", (ids, V), path, per,
            lambda: dedup_row(ids, V, path, per, "whisper cooperative embedding")))
        add_row(rows_out, "gather", gather_row(table, uniq, path, per))
        add_row(rows_out, "gather", gather_row(rows, inv, path, per))
        report_bounds(rows_out)
        out.update(rows_out)
    return out




# kernels of the redesigned wrappers, by name in a profile (the spmm
# backward's scan kernel comes from scan.cuh), every torch.sort of a step
# (CUB's radix sort, or PyTorch's in-place sort of small arrays), and every
# memset (two wrappers zero their scratch with one; so do other ops)
PROFILE_GROUPS = {
    "frontier_gather": ("frontier_gather_vec_kernel", "frontier_gather_any_kernel"),
    "unique_compact": ("unique_compact_kernel",),
    "spmm_forward": ("spmm_fwd_kernel",),
    "spmm_backward": ("bwd_count_kernel", "bwd_place_kernel", "bwd_rows_kernel",
                      "lookback_scan_kernel"),
    "seg_softmax_forward": ("seg_softmax_fwd_kernel",),
    "seg_softmax_backward": ("seg_softmax_bwd_kernel",),
    "every torch.sort": ("RadixSort", "SortKVInPlace"),
    "every memset": ("Memset",),
}
# a plan replay's kernels by kind: copies (mostly the float32 <-> float64
# conversions of rng._fma), float64 arithmetic, the plan's own kernels
REPLAY_COPIES = ("direct_copy_kernel",)
REPLAY_FLOAT64 = ("<double",)
PLAN_KERNELS = PROFILE_GROUPS["frontier_gather"] + PROFILE_GROUPS["unique_compact"]
# the serving path's plan and cache kernels, by name in a profile
SERVE_PROFILE_GROUPS = {
    "frontier_gather": PROFILE_GROUPS["frontier_gather"],
    "tag_probe": ("tag_probe_kernel", "tag_probe_any_kernel"),
}


def profile_train(tag: str, tds, gnn_cfg, tc, plan_ms: list, walls: list) -> None:
    """Device busy and idle share over ``PROFILE_STEPS`` steps (steps 5 and
    6 of a fresh engine and model, through ``train.step_program``, the
    program ``train_gnn`` replays; its first call, the capture, comes
    before the window, so both steps are replays) under torch.profiler,
    the kernels that take the device time, the device ms per step of
    ``PROFILE_GROUPS``, beside the captured run's plan ms per step
    (``plan_ms``, its ``plan`` span, warm steps 1..) and its warm steps
    (``walls``).  A step
    calls ``Graph.neighbor_table`` once per hop per PE; each call must
    make one ``frontier_gather`` launch (the wrapper's counter, which a
    replay advances by the launches its capture recorded) and one CUDA
    kernel (the profile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import MinibatchEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.gnn import init_gnn
    from repro_torch.train import adam_init, step_program

    engine = MinibatchEngine.from_config(tds.graph, tc.engine_config(gnn_cfg.num_layers),
                                         dataset=tds, device="cuda")
    model = init_gnn(gnn_cfg, seed=tc.seed, device="cuda")
    labels = torch.as_tensor(tds.labels).cuda()
    prog = step_program(engine, gnn_cfg, model, adam_init(model), labels, tc.lr)
    float(prog(tc.local_batch, engine.step_state(tc.num_steps))[0])  # warm-up + capture
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for step in range(tc.num_steps + 1, tc.num_steps + 1 + PROFILE_STEPS):
            float(prog(tc.local_batch, engine.step_state(step))[0])
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    stats = cuda_kernel_us(prof)
    fg_kernels = sum(c for _, c, key in stats
                     if any(p in key for p in PROFILE_GROUPS["frontier_gather"]))
    calls = tc.num_pes * gnn_cfg.num_layers * PROFILE_STEPS
    fg_launches = LAUNCHES.get("frontier_gather", 0)
    print(f"{tag} profile: {fg_launches} frontier_gather launches (counter) and {fg_kernels} "
          f"CUDA kernels (profile) for {calls} neighbor_table calls ({tc.num_pes} PEs x "
          f"{gnn_cfg.num_layers} hops x {PROFILE_STEPS} steps)")
    check(calls == fg_launches == fg_kernels,
          "frontier_gather: not one launch and one CUDA kernel per neighbor_table call")
    busy_ms = sum(d for d, _, _ in stats) / 1e3
    print(f"{tag} profile (profiler on), {PROFILE_STEPS} captured steps: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.2f} ms ({busy_ms / PROFILE_STEPS:.3f} a step, "
          f"{sum(c for _, c, _ in stats) / PROFILE_STEPS:.0f} kernels), idle share "
          f"{1 - busy_ms / wall_ms:.4f}")
    for dev_us, count, key in stats[:12]:
        print(f"  device {dev_us / 1e3:9.3f} ms  calls {count:6d}  {key[:90]}")
    groups = []
    for name, parts in PROFILE_GROUPS.items():
        hit = [(us, c) for us, c, key in stats if any(p in key for p in parts)]
        groups.append(f"{name} {sum(us for us, _ in hit) / 1e3 / PROFILE_STEPS:.4f} "
                      f"({sum(c for _, c in hit) / PROFILE_STEPS:.0f} kernels)")
    warm, whole = plan_ms[1:] or plan_ms, walls[1:] or walls
    print(f"{tag} profile device ms per step: " + ", ".join(groups)
          + f"; plan ms per step (captured card run's plan span, warm steps) mean {sum(warm) / len(warm):.3f} "
          + "[" + ", ".join(f"{v:.3f}" for v in warm) + "]; captured step ms (warm steps) "
          + f"mean {sum(whole) / len(whole):.3f}")


# --------------------------------------------------------------------------
# phase 13: the dry-run
# --------------------------------------------------------------------------
def child_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def start_child(args: list) -> subprocess.Popen:
    """A child process of this script's Python (a dry-run's fake process
    group never enters the script's own process)."""
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait_child(proc: subprocess.Popen, what: str) -> str:
    """Its output; fails on a non-zero exit or at ``DRYRUN_TIMEOUT_S``."""
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise PhaseError(f"{what}: killed at {DRYRUN_TIMEOUT_S} s\n{out[-4000:]}")
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}\n{out[-4000:]}")
    return out


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def dryrun_record(name: str) -> dict:
    return json.loads((ROOT / "experiments" / "dryrun_torch" / f"{name}.json").read_text())


def print_record(tag: str, r: dict, card: str) -> None:
    roof = r["roofline"]
    print(f"{tag} [{r['arch']} | {r['shape']} | {r['mesh']} | fake {r['overrides']['device']}]"
          f" {r['status']}: trace {r['trace_s']} s; per device: dot FLOPs "
          f"{roof['flops_per_dev']:.6e}, HBM bytes {roof['hbm_bytes_per_dev']:.6e}, "
          f"collective bytes {roof['coll_bytes_per_dev']:.6e} "
          f"{json.dumps(roof['coll_detail'])}; terms compute {roof['compute_s'] * 1e3:.3f} ms, "
          f"memory {roof['memory_s'] * 1e3:.3f} ms, collective {roof['collective_s'] * 1e3:.3f} "
          f"ms, bottleneck {roof['bottleneck']}; peak {r['memory']['peak_per_device_gb']:.3f} "
          f"GiB, arguments {r['memory']['argument_bytes']} B; kernel launches "
          f"{r.get('kernel_launches', {})}; H100 constants at 700 W; [{card}]", flush=True)


def dryrun_lm_child() -> None:
    """13b's trace: phase 12b's configuration on a one-device mesh, fake
    CUDA tensors; prints the record as the last line."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_combo
    from repro_torch.launch.specs import ShapeSpec

    cfg = get_config("gemma2-2b")
    rec = trace_combo("gemma2-2b", ShapeSpec("phase12", LM_TRAIN_SEQ, LM_TRAIN_B, "train"),
                      False, verbose=False, device="cuda", mesh_shape=(1, 1),
                      overrides={"dtype": cfg.dtype, "remat": cfg.remat})
    print(json.dumps(rec))


def gnn_scale() -> dict:
    """13c's configuration: phase 3's graph (scale 18) at the papers100M
    widths of the reference's dry-run (``SCALE``)."""
    from repro_torch.launch.gnn_dryrun import SCALE

    return dict(SCALE, log2_v=18)


def gnn_inputs():
    """Phase 3's graph with features, labels, seeds and weights at
    ``gnn_scale()``'s widths, from ``SEED``, on the host."""
    import numpy as np
    import torch
    from repro_torch.data import rmat_graph

    scale = gnn_scale()
    g = rmat_graph(scale=18, edge_factor=8, max_degree=32, seed=SEED, device="cpu")
    V = g.num_vertices
    rng = np.random.default_rng(SEED)
    host = {
        "indptr": g.indptr.to(torch.int32), "indices": g.indices.to(torch.int32),
        "v_start": torch.tensor(0, dtype=torch.int32),
        "feats": torch.from_numpy(rng.normal(size=(V, scale["feat_dim"])).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, scale["classes"], V).astype(np.int32)),
        "seeds": torch.from_numpy(rng.choice(V, scale["local_batch"],
                                             replace=False).astype(np.int32)),
    }
    L = scale["layers"]
    params = []
    for l in range(L):
        d_in = scale["feat_dim"] if l == L - 1 else scale["hidden"]
        d_out = scale["classes"] if l == 0 else scale["hidden"]
        params.append({"w": torch.from_numpy((rng.normal(size=(d_in, d_out)) / np.sqrt(d_in))
                                             .astype(np.float32)),
                       "b": torch.zeros(d_out)})
    return g, host, params


def dryrun_gnn_child(store: str) -> None:
    """13c: ``make_coop_train_step`` for real with one NCCL rank (P = 1):
    in float32 under ``FlopCounterMode`` (FLOPs, peak memory, time), and in
    float64 on the card and, in a gloo group of the same rank, on the CPU
    (plans, loss, step-0 gradients); prints the results as the last line.

    The gradients are compared in float64: in float32 the card's and the
    CPU's summation orders round a few of the 12.6M hidden units' inputs
    to opposite sides of the ReLU's kink, and one such unit moves a
    parameter's gradient by ~1e-3 of its largest entry."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core.cooperative import ShardExecutor, build_cooperative_minibatch
    from repro_torch.core.rng import DependentRNG
    from repro_torch.core.samplers import LaborSampler
    from repro_torch.launch.gnn_dryrun import (
        PLAN_BACKEND, BlockPartition, LocalGraph, _caps, make_coop_train_step)
    from repro_torch.train.optim import adam_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    gloo = dist.new_group(backend="gloo")
    scale = gnn_scale()
    g, host, params0 = gnn_inputs()
    caps = _caps(1, scale=scale)
    out = {"edges": int(host["indices"].shape[0]), "vertices": g.num_vertices}
    plans, runs = {}, {}
    for dev, group, dt in (("cuda", None, torch.float32), ("cuda", None, torch.float64),
                           ("cpu", gloo, torch.float64)):
        a = {k: v.to(dev) for k, v in host.items()}
        a["feats"] = a["feats"].to(dt)
        if dev not in plans:
            plan = build_cooperative_minibatch(
                LocalGraph(a["indptr"], a["indices"], a["v_start"], scale["max_degree"]),
                LaborSampler(fanout=scale["fanout"], backend=PLAN_BACKEND),
                BlockPartition(g.num_vertices, 1), a["seeds"],
                DependentRNG(base_seed=0, kappa=64).state_at(0), scale["layers"], caps,
                ShardExecutor(1, group=group), backend=PLAN_BACKEND)
            plans[dev] = [t.cpu() for t in [plan.input_ids, plan.seed_ids] + [
                getattr(layer, f) for layer in plan.layers
                for f in ("seeds", "self_idx", "nbr_idx", "mask", "slot_to_tilde", "req_idx",
                          "tilde_ids")]]
            del plan
        params = [{k: v.to(dev, dt).requires_grad_() for k, v in lp.items()} for lp in params0]
        opt = adam_init([p for lp in params for p in lp.values()])
        grads = []
        step = make_coop_train_step(1, group, caps, scale=scale,
                                    on_grads=lambda gs: grads.extend(x.detach().cpu() for x in gs))
        args = (a["indptr"], a["indices"], a["v_start"], a["feats"], a["labels"], a["seeds"], 0)
        t0 = time.perf_counter()
        if dev == "cuda" and dt == torch.float32:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as fc:
                _, _, loss = step(params, opt, *args)
                torch.cuda.synchronize()
            out["flops"] = fc.get_total_flops()
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        else:
            _, _, loss = step(params, opt, *args)
            if dev == "cuda":
                torch.cuda.synchronize()
        out[f"{dev}_{str(dt)[6:]}_ms"] = 1e3 * (time.perf_counter() - t0)
        runs[dev, dt] = (float(loss), grads)
        del params, opt, a
    out["plans_equal"] = all(torch.equal(x, y) for x, y in zip(plans["cuda"], plans["cpu"]))
    out["plan_leaves"] = len(plans["cuda"])
    card, cpu = runs["cuda", torch.float64], runs["cpu", torch.float64]

    def rel(got, want):
        return [float((x.double() - y.double()).abs().max() / max(float(y.abs().max()), 1e-300))
                for x, y in zip(got, want)]

    out["loss"] = [card[0], cpu[0], runs["cuda", torch.float32][0]]
    out["grad_err"] = rel(card[1], cpu[1])
    out["grad_err_float32_card"] = rel(runs["cuda", torch.float32][1], cpu[1])
    dist.destroy_process_group()
    print(json.dumps(out))


def dryrun_gnn_trace_child() -> None:
    """13c's trace: the same step on fake CUDA tensors, one PE."""
    _, host, _ = gnn_inputs()
    from repro_torch.launch.gnn_dryrun import trace_gnn_coop_step

    rec = trace_gnn_coop_step(verbose=False, device="cuda", num_pes=1, scale=gnn_scale(),
                              num_edges=int(host["indices"].shape[0]))
    print(json.dumps(rec))


def phase_dryrun(card: str, measured: dict) -> None:
    """Phase 13: the dry-run family (``repro_torch.launch.dryrun``), each
    part in a child process.  13a: the CLI on fake CUDA and fake CPU
    tensors, gemma2-2b ``train_4k`` and the papers100M GNN on the
    single-pod mesh; 13b: phase 12b's configuration traced on a
    one-device mesh against 12b's measured step (``measured``); 13c: the
    GNN step run for real (one NCCL rank, and on the CPU) against its
    trace."""
    import torch

    t_start = time.perf_counter()
    torch.cuda.empty_cache()  # the children need the card's memory
    # every child starts at once (about 7 busy cores of the machine's 8)
    lm13b = start_child(["-c", "import chip_smoke; chip_smoke.dryrun_lm_child()"])
    store = ROOT / "build" / f"dryrun-store-{os.getpid()}"
    store.unlink(missing_ok=True)
    gnn13c = (start_child(["-c", f"import chip_smoke; chip_smoke.dryrun_gnn_child({str(store)!r})"]),
              start_child(["-c", "import chip_smoke; chip_smoke.dryrun_gnn_trace_child()"]))
    try:
        phase13a(card)
        phase13b(card, measured, wait_child(lm13b, "phase13b trace"))
        phase13c(card, *(wait_child(p, f"phase13c {what}")
                         for p, what in zip(gnn13c, ("real step", "trace"))))
    finally:
        for p in (lm13b, *gnn13c):
            if p.poll() is None:
                p.kill()
                p.wait()
        store.unlink(missing_ok=True)
    print(f"phase13: {time.perf_counter() - t_start:.1f} s", flush=True)


def phase13a(card: str) -> None:
    """13a: the CLI on fake CUDA and fake CPU tensors (four children in
    parallel)."""
    t_start = time.perf_counter()
    cli = ["-m", "repro_torch.launch.dryrun"]
    jobs = {
        ("lm", "cuda"): cli + ["--arch", "gemma2-2b", "--shape", "train_4k", "--tag", "card"],
        ("lm", "cpu"): cli + ["--arch", "gemma2-2b", "--shape", "train_4k", "--tag", "cpu",
                              "--device", "cpu"],
        ("gnn", "cuda"): cli + ["--gnn", "--tag", "card"],
        ("gnn", "cpu"): cli + ["--gnn", "--tag", "cpu", "--device", "cpu"],
    }
    procs = {k: start_child(v) for k, v in jobs.items()}
    for k, p in procs.items():
        wait_child(p, f"phase13a {' '.join(jobs[k][2:])}")
    t13a = time.perf_counter() - t_start
    recs = {}
    for kind, name in (("lm", "gemma2-2b__train_4k__pod16x16"),
                       ("gnn", "gnn-coop-papers100M-gcn__b1024xP256__pod1x256")):
        for dev, tag in (("cuda", "card"), ("cpu", "cpu")):
            recs[kind, dev] = r = dryrun_record(f"{name}__{tag}")
            check(r["status"] == "ok", f"phase13a {name} {dev}: {r}")
            print_record("phase13a", r, card)
        a, b = recs[kind, "cuda"]["roofline"], recs[kind, "cpu"]["roofline"]
        check(a["flops_per_dev"] == b["flops_per_dev"]
              and a["coll_bytes_per_dev"] == b["coll_bytes_per_dev"],
              f"phase13a {name}: fake CUDA and fake CPU traces differ")
    launches = recs["gnn", "cuda"]["kernel_launches"]
    check(launches.get("frontier_gather", 0) > 0 and launches.get("unique_compact", 0) > 0
          and not recs["gnn", "cpu"]["kernel_launches"],
          f"phase13a: the fused plan's recorded launches {launches}")
    print(f"phase13a: fake CUDA and fake CPU traces equal in dot FLOPs and collective bytes; "
          f"the GNN trace recorded launches {launches}; {t13a:.1f} s (13b's trace beside it)",
          flush=True)


def phase13b(card: str, measured: dict, out: str) -> None:
    """13b: the LM dry-run (the child's output ``out``) against 12b's
    measured step."""
    r = last_json(out)
    print_record("phase13b", r, card)
    flops = r["roofline"]["flops_per_dev"]
    peak = r["memory"]["peak_per_device_gb"]
    want_peak = measured["peak_gib"] - measured["base_gib"]
    ratio = flops / measured["flops"]
    print(f"phase13b gemma2-2b train (B {measured['batch']}, S {measured['seq']}, float32, "
          f"remat) on a one-device mesh: traced dot FLOPs {flops:.6e} vs FlopCounterMode over "
          f"12b's step {measured['flops']:.6e} (ratio {ratio:.6f}); traced peak {peak:.3f} GiB "
          f"vs 12b's max_memory_allocated {measured['peak_gib']:.3f} GiB less "
          f"{measured['base_gib']:.3f} GiB held before ({want_peak:.3f} GiB, ratio "
          f"{peak / want_peak:.4f}); roofline terms compute {r['roofline']['compute_s'] * 1e3:.1f}"
          f" ms (67 TFLOP/s float32), memory {r['roofline']['memory_s'] * 1e3:.1f} ms, beside "
          f"12b's measured median step {measured['step_ms']:.1f} ms; [{card}]", flush=True)
    check(abs(ratio - 1) <= DRYRUN_FLOP_RTOL, f"phase13b: FLOP ratio {ratio}")
    check(abs(peak / want_peak - 1) <= DRYRUN_PEAK_RTOL,
          f"phase13b: peak {peak} GiB against {want_peak} GiB")


def phase13c(card: str, real: str, traced: str) -> None:
    """13c: the GNN step for real (one NCCL rank; float64 also on the
    CPU; :func:`dryrun_gnn_child`'s output ``real``) against its trace
    (``traced``)."""
    got, tr = last_json(real), last_json(traced)
    print_record("phase13c", tr, card)
    check(got["plans_equal"], "phase13c: card and CPU plans differ")
    loss_card, loss_cpu, loss_f32 = got["loss"]
    check(abs(loss_card - loss_cpu) <= TRAIN_RTOL * abs(loss_cpu),
          f"phase13c: losses {got['loss']}")
    check(max(got["grad_err"]) <= GRAD_RTOL, f"phase13c: gradients {got['grad_err']}")
    fl = tr["roofline"]["flops_per_dev"] / got["flops"]
    pk = tr["roofline"]["peak_mem_bytes"] / got["peak_bytes"]
    print(f"phase13c make_coop_train_step, P = 1, phase 3's graph (V {got['vertices']}, E "
          f"{got['edges']}) at papers100M widths (128/1024/172, caps of _caps(1)): the first card "
          f"step {got['cuda_float32_ms']:.1f} ms float32 (FlopCounterMode on), "
          f"{got['cuda_float64_ms']:.1f} ms float64; CPU step {got['cpu_float64_ms']:.1f} ms "
          f"float64; {got['plan_leaves']} plan leaves equal card vs CPU; float64 loss "
          f"{loss_card:.9f} vs {loss_cpu:.9f} (float32 card {loss_f32:.6f}); float64 step-0 "
          f"gradients within {max(got['grad_err']):.2e} of each largest |g| (float32 card "
          f"against them: {', '.join(f'{e:.1e}' for e in got['grad_err_float32_card'])}); "
          f"traced dot FLOPs {tr['roofline']['flops_per_dev']:.6e} vs FlopCounterMode "
          f"{got['flops']:.6e} (ratio {fl:.6f}); traced peak {tr['roofline']['peak_mem_bytes']}"
          f" B vs max_memory_allocated {got['peak_bytes']} B (ratio {pk:.4f}); [{card}]",
          flush=True)
    check(abs(fl - 1) <= DRYRUN_FLOP_RTOL, f"phase13c: FLOP ratio {fl}")
    check(abs(pk - 1) <= DRYRUN_PEAK_RTOL, f"phase13c: peak ratio {pk}")


def main(argv: list) -> int:
    t_start = time.perf_counter()
    kernels_only = argv == ["--kernels-only"]
    if argv and not kernels_only:
        print(f"usage: {sys.argv[0]} [--kernels-only]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: repro_torch not found under {ROOT / 'src'}; run from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    try:
        from repro_torch.core.minibatch import CapacityPlan
        from repro_torch.data import SyntheticGraphDataset, make_recsys, rmat_graph
        from repro_torch.engine import MinibatchEngine
        from repro_torch.models.gnn import GNNConfig
        from repro_torch.serve import ServeConfig, poisson_trace
        from repro_torch.train import TrainConfig

        info = phase0()
        t0 = time.perf_counter()
        ds = make_recsys(num_users=2**20, num_items=2**16, edges_per_user=8,
                         feature_dim=64, max_degree=64, seed=SEED, device="cuda")
        g = ds.graph
        print(f"recsys graph: V={g.num_vertices} E={g.num_edges} "
              f"max_degree={g.max_degree} features {ds.features.shape} "
              f"({ds.features.nbytes / 1e6:.0f} MB host) in {time.perf_counter() - t0:.1f} s")
        serve_cfg = ServeConfig(plan_backend="fused", use_cache=True)
        caps = CapacityPlan.geometric(
            serve_cfg.max_batch, serve_cfg.num_layers, serve_cfg.fanout, g.num_vertices
        ).caps
        cache_rows = max(serve_cfg.cache_ways, g.num_vertices // 4)
        cache_rows -= cache_rows % serve_cfg.cache_ways
        t0 = time.perf_counter()
        tds = SyntheticGraphDataset(
            rmat_graph(scale=18, edge_factor=8, max_degree=32, seed=SEED, device="cpu"),
            feature_dim=64, num_classes=16, seed=SEED,
        )
        tg = tds.graph
        train_cfg = GNNConfig(model="gcn", num_layers=3, in_dim=64, hidden_dim=256,
                              num_classes=16)
        gat_cfg = dataclasses.replace(train_cfg, model="gat", num_heads=4)
        tc = TrainConfig(mode="cooperative", num_pes=4, local_batch=64, fanout=10,
                         sampler="labor0", schedule="smoothed", kappa=16,
                         partition="hash", executor="sim", plan_backend="fused",
                         eval_every=0, num_steps=TRAIN_STEPS, seed=SEED)
        engine = MinibatchEngine.from_config(tg, tc.engine_config(3), dataset=tds,
                                             device="cuda")
        print(f"rmat graph: V={tg.num_vertices} E={tg.num_edges} max_degree="
              f"{tg.max_degree} features {tds.features.shape}, train ids "
              f"{len(tds.train_ids)}, in {time.perf_counter() - t0:.1f} s; cooperative "
              f"capacities per PE: caps {engine.caps.caps} tilde_caps "
              f"{engine.caps.tilde_caps} bucket_caps {engine.caps.bucket_caps}; row width "
              f"w={engine.sampler.row_width(engine.graph)}")
        t0 = time.perf_counter()
        rds = SyntheticGraphDataset(
            rmat_graph(scale=18, edge_factor=8, max_degree=32, num_edge_types=4, seed=SEED,
                       device="cpu"),
            feature_dim=RGCN_CFG["in_dim"], num_classes=RGCN_CFG["num_classes"], seed=SEED,
        )
        rgcn_cfg = GNNConfig(**RGCN_CFG)
        sage_cfg = dataclasses.replace(train_cfg, model="sage")
        ns_tc = dataclasses.replace(tc, sampler="ns")
        rgcn_engine = MinibatchEngine.from_config(rds.graph, tc.engine_config(3), dataset=rds,
                                                  device="cuda")
        sage_engine = MinibatchEngine.from_config(tg, ns_tc.engine_config(3), dataset=tds,
                                                  device="cuda")
        print(f"rmat graph with {rds.graph.num_edge_types} relations: E={rds.graph.num_edges}, "
              f"relation counts {rds.graph.edge_types.bincount().tolist()}, features "
              f"{rds.features.shape}, in {time.perf_counter() - t0:.1f} s; NS row width "
              f"w={sage_engine.sampler.row_width(sage_engine.graph)}")
        dep_engines = {mode: MinibatchEngine.from_config(
            rds.graph, dependent_config(tc, mode, 16), dataset=rds, device="cuda")
            for mode in DEP_MODES}
        t0 = time.perf_counter()
        k = phase1(ds, caps, cache_rows)
        for rows in (phase1_train(engine), phase1_mean(rgcn_engine, sage_engine),
                     phase1_paths(engine, rgcn_engine, sage_engine, tds, tc),
                     phase1_dependent(dep_engines, tc.num_pes)):
            for name, r in rows.items():
                k[name] = k.get(name, []) + r
        print(f"phase1: {sum(map(len, k.values()))} rows in {time.perf_counter() - t0:.1f} s")
        del engine, rgcn_engine, sage_engine, dep_engines
        ROWS_BY_INPUT.clear()  # the rows' inputs (a 0.8 GB feature table among them)
        if kernels_only:
            print("chip_smoke: --kernels-only: phases 0-1 done, no result line")
            return 0
        gnn_cfg = GNNConfig(model="gcn", num_layers=serve_cfg.num_layers,
                            in_dim=64, hidden_dim=256, num_classes=16)
        trace = poisson_trace(500, 4000.0, ds.user_ids, seed=SEED)
        serve = phase2(ds, gnn_cfg, serve_cfg, trace)
        k["spmm"].append(serve["spmm"])
        launches = {"serve": serve["launches"]}
        p3 = phase_train("phase3", "train", tds, train_cfg, tc, check_seeds=True)
        launches["train"] = p3["launches"]
        phase_compiled("phase3", tds, tc.engine_config(3))
        gat = phase_train("phase4", "train_gat", tds, gat_cfg, tc)
        launches["train_gat"] = gat["launches"]
        launches["coo"] = phase_coo(gat["plan0"])["launches"]
        del gat
        launches["train_rgcn"] = phase_train("phase6", "train_rgcn", rds, rgcn_cfg, tc,
                                             cpu_steps=RGCN_CPU_STEPS)["launches"]
        launches["train_sage"] = phase_train("phase7", "train_sage", tds, sage_cfg,
                                             ns_tc)["launches"]
        # against the eager build only: the training run above held the
        # replays of steps 1-3 against the CPU's plans
        phase_compiled("phase7", tds, ns_tc.engine_config(3), cpu=False)
        launches.update(phase_plans(tds, tc))
        launches["curves"] = phase_curves(tg)
        launches["dependent"] = phase_dependent(rds, tc)
        del rds
        launches["train_shard"] = phase_shard(tds, train_cfg, tc, p3)
        t0 = time.perf_counter()
        launches["examples"] = phase_examples()
        launches["analysis"] = phase_analysis(ds, serve_cfg, gnn_cfg,
                                              train=(tds, train_cfg, tc))
        print(f"phase10: {time.perf_counter() - t0:.1f} s")
        launches["lm"] = phase_lm(info["card"])
        p12 = phase_lm_train(info["card"])
        launches["lm_train"] = p12["launches"]
        for name, rows in p12["rows"].items():
            k[name] = k.get(name, []) + rows
        phase_dryrun(info["card"], p12["measured"])
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = []
    for name, meta in KERNELS.items():
        on_path = [row for row in k[name] if row["paths"]]
        r = max(on_path, key=lambda row: row["bytes"])  # its largest shape on a path
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_method": r["library_method"],
            "shape": r["shape"], "paths": r["paths"],
            "event_ms": r["event_ms"], "plain_event_ms": r["plain_event_ms"],
        })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
