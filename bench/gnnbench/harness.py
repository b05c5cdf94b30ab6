"""One run of one cell: set-up, the measured window, the traced steps, the
output check against the plain reference, and the result line.

The system under test is ``repro_torch``'s training step as one compiled
program (``repro_torch.train.loop.step_program``), replayed with
``engine.step_state(step)``.  Set-up makes the inputs, builds the engine,
the model, Adam and the program, and runs the first ``WARM_STEPS`` steps
through that program (the first call captures it); steps 0 to
``CHECK_STEPS - 1`` are the ones the reference follows.  On a card the
device then idles ``SETTLE_S`` seconds, which ``setup_s`` leaves out, and
``DEPTH`` more steps run.  The window then replays the same program for
``--seconds``:

* ``--trace 0``: steps are dispatched ahead, at most ``DEPTH`` in flight,
  with no host read of a loss; the losses are read after the sync that
  closes the window.  ``seeds_per_s`` is the global batch times the steps
  over the window's time, that last sync included.
* ``--trace 1``: every step ends in a sync (``step_ms``); after the window
  ``PROFILE_STEPS`` more steps run under ``torch.profiler``.

After the window the step program is freed and ``engine.plan_program``
(the same plan-building body that the step program captured) rebuilds the
plans of the checked and counted steps (and, traced, is timed alone); each
checked plan is held against the reference's, PE by PE and layer by layer
(:mod:`gnnbench.plancheck`).  Then the reference, given the same inputs,
trains the checked steps and the numbers of the output check are compared
with their limits.

What a cell's file sets is its traffic (the mode and the local batch), how
many steps' losses are compared, and the limits; the protocol (the
constants below) is the same for every cell.
"""
from __future__ import annotations

import gc
import math
import os
import statistics
import sys
import tempfile
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from gnnbench import inputs, loader, plancheck
from gnnbench.imports import forbidden_modules
from gnnbench.reference import Reference
from gnnbench.sampling import INVALID

DEPTH = 3          # steps in flight in the untraced window
NUM_PES = 4        # the paper's PEs, simulated on one card
EXECUTOR = "sim"
WARM_STEPS = 5     # steps of set-up, the checked ones among them
CHECK_STEPS = 3    # steps the reference follows
PROFILE_STEPS = 3  # steps under the profiler, after a traced window
COUNT_STEPS = 16   # window steps whose plans are counted (traced runs)
PLAN_REPLAYS = 10  # replays of the plan program timed alone (traced runs)
SETTLE_S = 40.0    # idle seconds before the last warm steps, on a card (PERF.md)


@dataclass
class Dataset:
    """What ``MinibatchEngine.from_config`` reads of a dataset."""

    graph: Any
    features: np.ndarray
    labels: np.ndarray
    train_ids: np.ndarray


class RunError(RuntimeError):
    """A run that must print no result (exit code ``code``)."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaf_key(name: str) -> tuple:
    _, l, leaf = name.split(".")
    return int(l), leaf


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def norm_gaps(got: dict, want: dict, keep=None) -> dict:
    """Per leaf, ``|‖got‖ - ‖want‖|`` over the larger of ``‖want‖`` of that
    leaf and of the median leaf (leaves in ``keep`` only, if given)."""
    g, w = _norms(got), _norms(want)
    keys = [k for k in w if keep is None or k in keep]
    med = statistics.median(w[k] for k in keys)
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys}


def compare(prog: dict, ref: dict, w0: dict, beta1: float, log=None) -> dict:
    """The numbers of the output check of ``CHECK_STEPS`` training steps.

    ``prog``: the program's losses, its Adam first moments after step 0
    (``mu0``) and its weights after the last checked step; ``ref``: what
    :meth:`Reference.train` returns.  The gradient and the change are each
    judged by their worst leaf.  Leaves whose first gradient is under a
    thousandth of the median leaf's in the reference move by round-off
    alone and are left out of the change.  With ``log``, each step's and
    each leaf's reading is written there."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grads = {k: m / (1 - beta1) for k, m in prog["mu0"].items()}
    gn = _norms(ref["grads"])
    med = statistics.median(gn.values())
    moved = {k for k, v in gn.items() if v >= 1e-3 * med}
    grad = norm_gaps(grads, ref["grads"])
    change = norm_gaps({k: prog["weights"][k] - w0[k] for k in w0},
                       {k: ref["weights"][k] - w0[k] for k in w0}, moved)
    if log is not None:
        for t, (a, b) in enumerate(zip(prog["losses"], ref["losses"])):
            print(f"detail loss step {t} program {a!r} reference {b!r}", file=log)
        for k in gn:
            print(f"detail leaf {k[0]}.{k[1]} grad_norm {gn[k]!r} grad_gap {grad[k]!r} "
                  f"change_gap {change.get(k)!r}", file=log)
    return {"loss_gap": max(losses), "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        bench_dir=loader.BENCH_DIR, root=loader.ROOT, t_start: Optional[float] = None,
        log=sys.stderr) -> dict:
    """One run; returns the result object the last line prints."""
    t0 = time.perf_counter() if t_start is None else t_start
    if device == "cuda":
        torch.cuda.init()
    print(f"detail start {time.perf_counter() - t0:.3f}", file=log)
    bench = loader.benchmark(root)
    entry = loader.workload_entry(bench, workload)
    cell = loader.cell(workload, bench_dir)
    cfg = loader.config(cell["config"], bench_dir)
    if entry["config"] != cell["config"]:
        raise loader.BenchDataError(f"{workload}: BENCHMARK.json names configuration "
                                    f"{entry['config']!r}, the cell file {cell['config']!r}")
    readers = {m["name"]: (m, loader.reader(m["name"], bench_dir))
               for m in loader.metrics_for(bench, workload, trace)}
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 as configured
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.graph import Graph
    from repro_torch.engine import MinibatchEngine
    from repro_torch.models.gnn import GNN, GNNConfig
    from repro_torch.train.loop import TrainConfig, step_program
    from repro_torch.train.optim import adam_init

    mc, gc_, sc, oc = cfg["model"], cfg["graph"], cfg["sampler"], cfg["optimizer"]
    P, b = NUM_PES, cell["local_batch"]
    # -- inputs, made on the device from the seed -------------------------
    ga = inputs.graph_of(seed, cfg, dev)
    _sync(dev)
    marks = {"graph": time.perf_counter() - t0}
    print("detail graph " + " ".join(f"{k} {v!r}" for k, v in
                                     inputs.degree_stats(ga, gc_["max_degree"]).items()),
          file=log)
    labels = inputs.labels(seed, ga.num_vertices, mc["num_classes"], dev)
    train = inputs.train_ids(seed, ga, gc_["train_fraction"], dev)
    feats = inputs.features(seed, ga.num_vertices, mc["in_dim"], dev)
    host_feats = feats.cpu().numpy()   # from_config takes the features as numpy
    del feats
    w0 = inputs.weights(seed, mc, dev)
    graph = Graph(indptr=ga.indptr, indices=ga.indices, edge_types=ga.etypes,
                  max_degree=ga.max_degree, num_vertices=ga.num_vertices,
                  num_edges=int(ga.indices.numel()), num_edge_types=ga.num_edge_types)
    ds = Dataset(graph, host_feats, labels.cpu().numpy(), train.cpu().numpy())
    _sync(dev)
    marks["inputs"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the system under test --------------------------------------------
    tc = TrainConfig(mode=cell["mode"], num_pes=P, local_batch=b, num_steps=0,
                     lr=oc["lr"], sampler=sc["name"], fanout=sc["fanout"],
                     schedule=sc["schedule"], kappa=sc["kappa"], partition=sc["partition"],
                     seed=seed, eval_every=0, plan_backend=sc["plan_backend"],
                     executor=EXECUTOR)
    engine = MinibatchEngine.from_config(graph, tc.engine_config(mc["num_layers"]),
                                         dataset=ds, device=dev)
    gnn_cfg = GNNConfig(model=mc["kind"], num_layers=mc["num_layers"], in_dim=mc["in_dim"],
                        hidden_dim=mc["hidden_dim"], num_classes=mc["num_classes"],
                        num_relations=mc.get("num_relations", 1))
    model = GNN(gnn_cfg, device=dev)
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(w0[_leaf_key(name)])
    del w0
    opt = adam_init(list(model.parameters()))
    marks["engine"] = time.perf_counter() - t0
    program = step_program(engine, gnn_cfg, model, opt, labels, oc["lr"])
    order = [_leaf_key(n) for n in named]

    def step_call(s: int) -> torch.Tensor:
        return program(b, engine.step_state(s))[0]

    checked = []
    mu0 = after = None
    for s in range(WARM_STEPS):
        checked.append(step_call(s))
        if s == 0:
            mu0 = {k: m.detach().clone() for k, m in zip(order, opt.mu)}
            _sync(dev)
            marks["first_step"] = time.perf_counter() - t0
        if s == CHECK_STEPS - 1:
            after = {k: p.detach().clone() for k, p in zip(order, model.parameters())}
    # the card runs the step slower for some seconds after set-up (PERF.md):
    # it idles ``SETTLE_S``, which set-up's time leaves out, then ``DEPTH``
    # more steps warm up
    _sync(dev)
    settle = SETTLE_S if dev.type == "cuda" else 0.0
    ts = time.perf_counter()
    time.sleep(settle)
    settle = time.perf_counter() - ts
    step = WARM_STEPS
    for _ in range(DEPTH):
        step_call(step)
        step += 1
    _sync(dev)
    setup_s = time.perf_counter() - t0 - settle
    print("detail setup " + " ".join(f"{k} {v:.3f}" for k, v in marks.items())
          + f" settle {settle:.3f} setup_s {setup_s:.3f}", file=log)

    # -- the window --------------------------------------------------------
    window_start, losses, step_s, inflight = step, [], {}, deque()
    tw0 = time.perf_counter()
    while True:
        if trace:
            ts = time.perf_counter()
            losses.append(step_call(step))
            _sync(dev)
            step_s[step] = time.perf_counter() - ts
        else:
            losses.append(step_call(step))
            if dev.type == "cuda":
                _bounded(inflight)
        step += 1
        if time.perf_counter() - tw0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - tw0
    window_steps = list(range(window_start, step))
    failed = sum(not math.isfinite(v) for v in torch.stack(losses).double().tolist())

    tr = None
    profiled = []
    if trace:
        profiled = list(range(step, step + PROFILE_STEPS))
        tr = _profile(dev, lambda: [step_call(s) for s in profiled])
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: {found}", 4)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    report = program.report()
    prog_out = {"losses": [float(x) for x in checked[: cell["loss_steps"]]], "mu0": mu0,
                "weights": after}
    del program, opt, model, named, checked, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the plans, from engine.plan_program, the checked ones held against
    # the reference's --------------------------------------------------------
    ref = Reference(ga, labels, train, cfg, cell["mode"], P, b, seed)
    plan_prog = engine.plan_program
    input_rows, plan_bad = {}, {}
    counted = window_steps[:COUNT_STEPS] if trace else []
    for s in sorted(set(range(CHECK_STEPS)) | set(counted)):
        plan, _ = plan_prog(b, engine.step_state(s))
        if s < CHECK_STEPS:
            bad = plancheck.mismatch(plan, ref.pe_work(s), ref.owner, ga.num_vertices,
                                     ga.num_edge_types, cell["mode"] == "cooperative")
            for k, v in bad.items():
                plan_bad[k] = plan_bad.get(k, 0) + v
        input_rows[s] = int((plan.input_ids != INVALID).sum())
        del plan
    print("detail plan " + " ".join(f"{k} {v}" for k, v in plan_bad.items()), file=log)
    plan_ms = None
    if trace and dev.type == "cuda":
        states = [engine.step_state(s) for s in window_steps[:PLAN_REPLAYS]]
        _sync(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for st in states:
            plan_prog(b, st)
        end.record()
        _sync(dev)
        plan_ms = start.elapsed_time(end) / len(states)
    del engine, plan_prog, ds, host_feats, graph
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the output check ---------------------------------------------------
    feats = inputs.features(seed, ga.num_vertices, mc["in_dim"], dev)
    w0 = inputs.weights(seed, mc, dev)
    ref_out = ref.train(lambda ids: feats[ids], w0, CHECK_STEPS)
    numbers = compare(prog_out, ref_out, w0, oc["beta1"], log)
    numbers["plan_mismatch"] = sum(plan_bad.values())
    del ref_out, prog_out
    checks = {k: {"value": numbers[k], "limit": cell["limits"][k]} for k in sorted(numbers)}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0

    # -- the metrics ----------------------------------------------------------
    ctx = {
        "cell": cell, "config": cfg, "model": mc, "global_batch": P * b,
        "setup_s": setup_s, "peak_bytes": peak,
        "window": {"seconds": window_s, "steps": len(window_steps)},
        "step_s": step_s, "counted_steps": counted, "profiled_steps": profiled,
        "input_rows": input_rows, "plan_ms": plan_ms, "program_report": report,
        "trace": tr, "work": ref.pe_work,
    }
    metrics = {}
    for name, (m, read) in readers.items():
        value = read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(window_steps), "failed": failed,
           "metrics": metrics, "device": _device(dev, entry["chips"], peak, tr)}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return out


def _bounded(inflight: deque) -> None:
    """Records an event after the step just dispatched and waits for the one
    ``DEPTH`` steps back, so that at most ``DEPTH`` steps are in flight."""
    ev = torch.cuda.Event()
    ev.record()
    inflight.append(ev)
    if len(inflight) > DEPTH:
        inflight.popleft().synchronize()


def _device(dev: torch.device, chips: int, peak: int, tr) -> dict:
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
           "count": chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
    return out


def _profile(dev: torch.device, steps):
    """Runs ``steps()`` under ``torch.profiler`` inside the annotation that
    bounds the traced window; its trace, reduced (:mod:`gnnbench.traces`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gnnbench import traces

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        with record_function(traces.WINDOW):
            steps()
            _sync(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return traces.load(path)
    finally:
        os.remove(path)
