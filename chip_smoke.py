#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

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
   kernel's device time (CUDA-graph replay) and event time, its plain
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
   the new path there).  The ``seg_softmax`` rows print the
   replaced design's time beside the new one ("was"), the
   ``frontier_gather`` rows the replaced design's separate mask op
   (``nbr != INVALID``) by graph replay at the same shape.  The two deepest
   dedups are also timed whole (sort + kernel) beside ``torch.unique``.
2. Serve: a 1.1M-vertex user-item graph (``make_recsys`` with 2**20
   users), the GCN at full width (in 64, hidden 256, 16 classes, two
   layers) with ``init_gnn``'s weights for seed 0 (the JAX package's
   initial weights for that seed), and a 500-request Poisson
   trace at 4000 requests/s through ``repro_torch.serve.GNNServer``
   with ``plan_backend="fused"`` and the device cache on.  The launch
   counters are zeroed right before and read right after; every kernel
   of the path (the GCN's ``spmm`` forward too) must have launched.  The
   same trace through a ``device="cpu"`` server (the plain path) must give
   identical integer accounting, every batch's plan entries equal bit for
   bit, and logits within ``atol=1e-4``; ``spmm`` must equal its plain
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
   the card and the same 4 steps on the CPU (the plain path).  The
   counters are zeroed right before the card run; every kernel of the
   path must have launched.  Seed batches, every integer leaf of every
   step's plan and the plan stats must equal the CPU run's; losses agree
   within ``rtol=1e-4`` and the final weights within ``atol=1e-4``.  Per
   step: wall ms split into plan, gather, forward+backward and Adam (each
   ended by a sync) and each kernel's launches; then the device idle
   share over two more steps under the profiler, with the device ms per
   step of the ``frontier_gather`` and ``unique_compact`` kernels, the
   ``spmm`` and ``seg_softmax`` forward and backward kernels, every sort
   and every memset, beside the plan ms per step; each
   ``Graph.neighbor_table`` call there must make one ``frontier_gather``
   launch and one CUDA kernel.
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
   trained and checked as in phase 3; one cooperative ``plan_at(0)`` each
   with the ``rw`` and ``full`` samplers, every integer leaf equal to the
   CPU's; and the work curves of Thm 3.1/3.2 (``measure_work_curve``, 3
   layers, 2 trials at batch sizes 64, 256 and 1,024) for ``ns``,
   ``labor0``, ``labor*`` and ``rw``, counts equal to the CPU's.

The second-to-last line of output is a JSON object with one entry per
kernel, at its largest shape on a path; the last line is ``{"ok": true,
"device": {...}}``.  Any failed phase exits non-zero without that line.  Without a CUDA device, or
without the rest of the repository next to this file, it exits 1.
"""
from __future__ import annotations

import dataclasses
import functools
import json
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
SPANS = ("rng.vertex_uniform", "store.clock_access", "rng.edge_uniform")
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
    replayed ``replays`` times between CUDA events (no host gaps)."""
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
        span = getattr(ev, "is_user_annotation", False) or ev.key in SPANS
        if ev.device_type == DeviceType.CUDA and not span:
            us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
            rows.append((us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profiled_kernels(fn, iters: int = 20) -> list:
    """(device us, launches, name) per call of each kernel (and memset) that
    ``fn`` launches, from a torch.profiler trace."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = []
    for us, count, key in cuda_kernel_us(prof):
        name = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
        out.append((us / iters, count / iters, name.group(1) if name else key[:24]))
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

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return any("synchroniz" in str(w.message) for w in caught)


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
    want = {Path(meta["source"]).stem for meta in KERNELS.values()}
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
    from repro_torch.store import hash_set, probe_ref, tag_probe_cuda

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
    tags_t = torch.from_numpy(tags).to(dev)
    n = len(ids)
    got = tag_probe_cuda(tags_t, sets, ids_t)
    want = probe_ref(tags_t, sets, ids_t)
    err = int((got != want).sum())
    check(err == 0, f"tag_probe n={n}: {err} entries differ from plain")
    call = lambda: tag_probe_cuda(tags_t, sets, ids_t)
    split = profiled_kernels(call)
    check(len(split) == 1 and split[0][1] <= 1 and "tag_probe" in split[0][2]
          and launches_per_call("tag_probe", call) == 1,
          f"tag_probe: not one kernel a call: {split}")
    nbytes = 4 * n * 3 + 4 * W * int(torch.unique(sets).numel())
    # per id: the row address, then one compare per way up to the first match
    ops = n + int(torch.where(want >= 0, want + 1, W).sum())
    out["tag_probe"] = [dict(
        shape=f"n={n} S={S} W={W}", bytes=nbytes, ops=ops,
        max_abs_err=max_abs_err(got, want), paths=["serve"], per="1/batch",
        extra_split=kernel_split(split),
        **timings(lambda: tag_probe_cuda(tags_t, sets, ids_t),
                  lambda: probe_ref(tags_t, sets, ids_t)),
    )]

    report_bounds(out)
    return out


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
    add_row(out, "gather", gather_row(engine, plan, train, "1/step"))
    caps, L = engine.caps, len(plan.layers)

    # spmm at every layer's (S~ rows, owned rows, d_in) for PE 0: the GCN
    # runs the forward at every layer, the backward where its input needs a
    # gradient (not plan layer L-1, which reads the raw features)
    fwd, bwd = [], []
    for l, layer in enumerate(plan.layers):
        d = 64 if l == L - 1 else 256
        f, b = spmm_rows(layer.nbr_idx[0], layer.mask[0], caps.tilde_caps[l], d, rng,
                         paths=["train"], per=per_pe, backward_on_path=l < L - 1,
                         label=f"layer {l}")
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


def gather_row(engine, plan, paths: list, per: str):
    """``gather`` of all PEs' owned input ids of ``plan`` from ``engine``'s
    feature table against its plain version, equal bit for bit (through
    :func:`shared_row`).  Bytes: the ids, each distinct valid row read
    once, the output written once."""
    import torch
    from repro_torch.core.graph import INVALID
    from repro_torch.kernels.gather import gather_cuda, gather_ref

    table = engine.store.features
    ids = plan.input_ids.reshape(-1).contiguous()

    def make():
        V, d = table.shape
        n = ids.shape[0]
        got, want = gather_cuda(table, ids), gather_ref(table, ids)
        check(torch.equal(got, want), f"gather V={V} d={d} n={n}: differs from plain")
        valid = ids[ids != INVALID]
        rows_read = int(torch.unique(valid).numel())
        clamped = ids.clamp(0, V - 1)
        err = float_err(got, want)
        del got, want
        # 5 calls a graph at d = 64; fewer for a wider table (3.2 GB an output at d = 768)
        calls = max(1, 5 * 64 // d)
        return dict(
            shape=f"V={V} d={d} n={n} ({int(valid.numel())} valid)",
            bytes=4 * n + 4 * d * rows_read + 4 * n * d, ops=n, max_abs_err=err,
            paths=paths, per=per,
            **timings(lambda: gather_cuda(table, ids), lambda: gather_ref(table, ids),
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
    from repro_torch.core.samplers import make_sampler
    from repro_torch.core.theory import sample_work_curve
    from repro_torch.engine import MinibatchEngine

    out = {"frontier_gather": [], "unique_compact": [], "gather": []}
    P = tc.num_pes
    for path, eng, tag in (("train_rgcn", rgcn_engine, "rgcn "), ("train_sage", sage_engine, "ns ")):
        plan = eng.plan_at(0)
        plan_rows(out, eng, plan, [path], f"{P}/step", tag)
        add_row(out, "gather", gather_row(eng, plan, [path], "1/step"))
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
    plan_entries, plan_diff = compare_plans(server, cpu, rep)
    print(f"phase2 plan leaves card vs cpu: {plan_entries} entries over "
          f"{len(rep.batches)} batches, {plan_diff} differ")
    check(plan_diff == 0, f"{plan_diff} plan entries differ from the CPU build")
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


def compare_plans(card, cpu, report) -> tuple[int, int]:
    """Rebuild every served batch's plan on the card and on the CPU and
    count the integer plan entries that differ (seeds, self_idx, nbr_idx,
    mask of every layer, and the input frontier)."""
    groups: dict[int, list] = {}
    for s in report.served:
        groups.setdefault(s.batch_index, []).append(s.request)
    entries = differ = 0
    for _, reqs in sorted(groups.items()):
        plans = []
        for server in (card, cpu):
            plans.append(server.coalescer.build_plan(server.coalescer.coalesce(reqs, 0.0)))
        for a, b in zip(*(
            [t for layer in p.layers
             for t in (layer.seeds, layer.self_idx, layer.nbr_idx, layer.mask)]
            + [p.input_ids] for p in plans
        )):
            entries += a.numel()
            differ += int((a.cpu() != b).sum())
    return entries, differ


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
    host time inside the port's two profiler spans, beside the stage that
    holds each (all with the profiler's own overhead)."""
    import torch
    from torch.autograd import DeviceType
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
    spans = {ev.key: ev.cpu_time_total / 1e3 / nb for ev in prof.key_averages()
             if ev.key in SPANS and ev.device_type == DeviceType.CPU}
    print(f"phase2 profile (profiler on): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.4f}; host ms per "
          f"batch: plan {plan_ms:.3f}, of it rng.vertex_uniform "
          f"{spans.get(SPANS[0], 0.0):.3f}; gather {gather_ms:.3f}, of it "
          f"store.clock_access {spans.get(SPANS[1], 0.0):.3f}")
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
    """Every integer (and bool) leaf of a cooperative plan, by name."""
    out = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in ("seeds", "self_idx", "nbr_idx", "mask", "etypes",
                     "slot_to_tilde", "req_idx", "tilde_ids"):
            if getattr(layer, name) is not None:
                out[f"{name}{l}"] = getattr(layer, name)
    return out


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
    launches, the loss gap, the walls and the card's step-0 plan."""
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

    plans, first, per_step = {"cuda": [], "cpu": []}, {}, []

    def run(dev: str, steps: int):
        """``steps`` steps on ``dev`` from ``init_gnn(cfg, tc.seed)`` (the
        weights ``train_gnn`` draws by default); keeps each step's plan, the
        initial weights and the step-0 gradient of every parameter (a hook
        on each, removed after step 0)."""
        model = init_gnn(gnn_cfg, seed=tc.seed, device=dev)
        named = list(model.named_parameters())
        grads = {}

        def keep(i, g):
            if i not in grads:
                grads[i] = g.detach().clone()

        hooks = [p.register_hook(functools.partial(keep, i)) for i, (_, p) in enumerate(named)]
        first[dev] = {"names": [n for n, _ in named],
                      "init": [p.detach().cpu().numpy().copy() for _, p in named]}

        def on_step(step, plan):
            plans[dev].append(plan)
            if dev == "cuda":
                per_step.append({k: LAUNCHES.get(k, 0) for k in KERNELS})
            if step == 0:
                for h in hooks:
                    h.remove()
                first[dev]["grad"] = [grads[i].cpu().numpy() for i in range(len(named))]

        return train_gnn(tds, gnn_cfg, dataclasses.replace(tc, num_steps=steps), model=model,
                         device=dev, stage_times=True, on_step=on_step)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = run("cuda", tc.num_steps)
    card_s = time.perf_counter() - t0
    launches = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    print(f"{tag} card train ({gnn_cfg.model}): {tc.num_steps} steps in {card_s:.2f} s "
          f"(engine set-up included); launches {launches}")
    for k in PATH_KERNELS[path]:
        check(launches[k] > 0, f"kernel {k} was not launched on the {path} path")
    calls = {"gcn": 1, "sage": 1, "rgcn": gnn_cfg.num_relations}.get(gnn_cfg.model, 0)
    want = {"spmm": tc.num_pes * L * calls, "spmm_backward": tc.num_pes * (L - 1) * calls}
    prev = {k: 0 for k in KERNELS}
    for step, (st, cum) in enumerate(zip(card.stage_ms, per_step)):
        per = {k: cum[k] - prev[k] for k in KERNELS if cum[k] - prev[k]}
        prev = cum
        print(f"{tag} card step {step}: wall {sum(st.values()):.3f} ms = "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
              + f"; loss {card.losses[step]:.6f}; launches {per}")
        if calls:
            got = {k: per.get(k, 0) for k in want}
            check(got == want, f"step {step}: spmm launches {got}, want {want}")
    print(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    cpu = run("cpu", cpu_steps)
    print(f"{tag} cpu train (plain path, {cpu_steps} steps): {time.perf_counter() - t0:.2f} s; "
          "per step " + "; ".join(f"{sum(st.values()):.1f} ms" for st in cpu.stage_ms))

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
    walls = [sum(st.values()) for st in card.stage_ms]
    profile_train(tag, tds, gnn_cfg, tc, [st["plan"] for st in card.stage_ms])
    return {"launches": launches, "loss_rel": loss_rel, "walls": walls,
            "plan0": plans["cuda"][0]}


def check_gradients(tag: str, card: dict, cpu: dict) -> None:
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
    print(f"{tag} step 0 card vs cpu: initial weights equal; gradients within {worst:.3e} of "
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
# the serving path's plan and cache kernels, by name in a profile
SERVE_PROFILE_GROUPS = {
    "frontier_gather": PROFILE_GROUPS["frontier_gather"],
    "tag_probe": ("tag_probe_kernel", "tag_probe_any_kernel"),
}


def profile_train(tag: str, tds, gnn_cfg, tc, plan_ms: list) -> None:
    """Device busy and idle share over ``PROFILE_STEPS`` steps (steps 4 and
    5 of a fresh engine and model, through ``train_step``, the step
    ``train_gnn`` runs) under torch.profiler, the kernels that take the
    device time, the device ms per step of ``PROFILE_GROUPS``, beside the
    card run's plan ms per step (``plan_ms``, its warm steps 1..), and the
    host time in the sampler's variates.  A step calls ``Graph.neighbor_table``
    once per hop per PE; each call must make one ``frontier_gather``
    launch (the wrapper's counter) and one CUDA kernel (the profile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import MinibatchEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.gnn import init_gnn
    from repro_torch.train import adam_init, train_step

    engine = MinibatchEngine.from_config(tds.graph, tc.engine_config(gnn_cfg.num_layers),
                                         dataset=tds, device="cuda")
    model = init_gnn(gnn_cfg, seed=tc.seed, device="cuda")
    labels = torch.as_tensor(tds.labels).cuda()
    opt = adam_init(list(model.parameters()))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for step in range(tc.num_steps, tc.num_steps + PROFILE_STEPS):
            loss, opt, _ = train_step(engine, gnn_cfg, model, opt, labels, step, tc.lr)
            float(loss.detach())
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
    rng_ms = sum(ev.cpu_time_total for ev in prof.key_averages()
                 if ev.key.startswith("rng.") and ev.device_type == DeviceType.CPU) / 1e3
    print(f"{tag} profile (profiler on), {PROFILE_STEPS} steps: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.4f}; host ms "
          f"per step in the sampler's variates (rng.vertex_uniform or rng.edge_uniform) "
          f"{rng_ms / PROFILE_STEPS:.3f}")
    for dev_us, count, key in stats[:12]:
        print(f"  device {dev_us / 1e3:9.3f} ms  calls {count:6d}  {key[:90]}")
    groups = []
    for name, parts in PROFILE_GROUPS.items():
        hit = [(us, c) for us, c, key in stats if any(p in key for p in parts)]
        groups.append(f"{name} {sum(us for us, _ in hit) / 1e3 / PROFILE_STEPS:.4f} "
                      f"({sum(c for _, c in hit) / PROFILE_STEPS:.0f} kernels)")
    warm = plan_ms[1:] or plan_ms
    print(f"{tag} profile device ms per step: " + ", ".join(groups)
          + f"; plan ms per step (card run, warm steps) mean {sum(warm) / len(warm):.3f} "
          + "[" + ", ".join(f"{v:.3f}" for v in warm) + "]")


def main(argv: list) -> int:
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
        t0 = time.perf_counter()
        k = phase1(ds, caps, cache_rows)
        for rows in (phase1_train(engine), phase1_mean(rgcn_engine, sage_engine),
                     phase1_paths(engine, rgcn_engine, sage_engine, tds, tc)):
            for name, r in rows.items():
                k[name] = k.get(name, []) + r
        print(f"phase1: {sum(map(len, k.values()))} rows in {time.perf_counter() - t0:.1f} s")
        del engine, rgcn_engine, sage_engine
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
        launches["train"] = phase_train("phase3", "train", tds, train_cfg, tc,
                                        check_seeds=True)["launches"]
        gat = phase_train("phase4", "train_gat", tds, gat_cfg, tc)
        launches["train_gat"] = gat["launches"]
        launches["coo"] = phase_coo(gat["plan0"])["launches"]
        del gat
        launches["train_rgcn"] = phase_train("phase6", "train_rgcn", rds, rgcn_cfg, tc,
                                             cpu_steps=RGCN_CPU_STEPS)["launches"]
        del rds
        launches["train_sage"] = phase_train("phase7", "train_sage", tds, sage_cfg,
                                             ns_tc)["launches"]
        launches.update(phase_plans(tds, tc))
        launches["curves"] = phase_curves(tg)
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
