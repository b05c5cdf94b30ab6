"""GNN training loop over :class:`MinibatchEngine` (port of ``repro.train.loop``).

Both minibatching modes run the same model code, the same loss path and
the same global batch size, the paper's controlled comparison (§4.3,
Fig. 9).  The mode lives inside the engine:

* independent: P PEs × local batch b, P separate plans (stacked),
  gradients of the mean loss over all PEs' seeds;
* cooperative: ONE global batch of size b·P partitioned by ownership,
  all-to-all exchanges during sampling and forward/backward (Alg. 1).

One step: the seed draw and plan (``engine.plan_at``), the gather of the
input features (the ``gather`` kernel on a card), the GCN (``spmm``
forward and backward kernels on a card) or the GAT (``seg_softmax``
forward and backward kernels), masked cross-entropy, backward and Adam.

As the JAX package compiles its ``train_step`` into one program with the
step a traced argument, ``train_gnn`` runs the whole step as one
:class:`repro_torch.engine.compiled.CompiledFunction`
(:func:`step_program`): on a card with the fused backend one captured
CUDA graph, replayed every step, that reads its step from the
:class:`repro_torch.core.rng.DeviceRNGState` buffer and updates the
weights, Adam's moments and its device step in place.  Its first call
runs step 0 eagerly on a side stream and then captures.  The CPU and
the reference backend run the same body eagerly.  The program records
its stages as spans (:mod:`repro_torch.utils.spans`: marker kernels in
the graph, host clocks on the CPU), which ``stage_times=True`` reads
after every step.

With ``TrainConfig(executor="shard")`` (cooperative) every rank of a
``torch.distributed`` process group runs this loop for its own PE: the
rank's plan (``engine.shard_runner``'s build), then the gather and
forward+backward of ``ShardRunner.plan_loss_and_grad``, whose exchanges
cross the ranks, and an all-reduce of the loss shares and gradients
before Adam, so every rank's weights stay equal bit for bit.  The step
is :func:`step_program` there too, as the JAX package jits its
``train_step`` around ``ShardRunner.make_loss_and_grad``: one captured
CUDA graph a rank when the group runs NCCL (its collectives recorded
into the graph, replayed in lockstep by every rank), eager under gloo.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import frontier
from repro_torch.core.cooperative import ShardExecutor
from repro_torch.core.graph import INVALID
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import EngineConfig, MinibatchEngine
from repro_torch.engine.compiled import CompiledFunction
from repro_torch.models.gnn import GNN, GNNConfig, init_gnn
from repro_torch.train.metrics import masked_softmax_xent, micro_f1
from repro_torch.train.optim import AdamState, adam_init, adam_update
from repro_torch.utils.spans import MAX_LAYERS, count, span

STAGES = ("plan", "gather", "forward_backward", "adam")
SHARD_STAGES = ("plan", "gather", "forward_backward", "all_reduce", "adam")


@dataclass
class TrainConfig:
    mode: str = "cooperative"        # independent | cooperative
    num_pes: int = 4
    local_batch: int = 64            # b; global batch = b * P
    num_steps: int = 100
    lr: float = 1e-3
    sampler: str = "labor0"
    fanout: int = 10
    schedule: str = "smoothed"       # iid | smoothed | nested
    kappa: Optional[int] = 1         # dependent-minibatching window
    partition: str = "hash"
    seed: int = 0
    eval_every: int = 25
    plan_backend: str = "reference"  # reference | fused (the CUDA kernels on a card)
    executor: str = "sim"            # sim | shard (one PE per rank, cooperative only)

    def engine_config(self, num_layers: int) -> EngineConfig:
        return EngineConfig(
            mode=self.mode, num_pes=self.num_pes, local_batch=self.local_batch,
            num_layers=num_layers, sampler=self.sampler, fanout=self.fanout,
            schedule=self.schedule, kappa=self.kappa, partition=self.partition,
            seed=self.seed, plan_backend=self.plan_backend,
            executor=self.executor,
        )


@dataclass
class TrainResult:
    model: GNN
    losses: list = field(default_factory=list)
    val_f1: list = field(default_factory=list)
    stage_ms: list = field(default_factory=list)  # per step {stage: ms} of its spans, if timed
    step_ms: list = field(default_factory=list)   # per step wall ms, to the loss read
    # the step program's capture per key (ms, pool bytes, launches a replay)
    # and its signatures per key; empty where the step ran eagerly
    compiled: dict = field(default_factory=dict)
    # cooperative, if timed: per step {kind: (exchanges, bytes, ms)} of the
    # all-to-alls ("ids", "forward", "backward"; a shard rank's own)
    exchanges: list = field(default_factory=list)

    @property
    def params(self) -> dict:
        """Parameters in the JAX package's pytree layout, as numpy arrays."""
        return {"layers": [
            {name: p.detach().cpu().numpy() for name, p in layer.named_parameters()}
            for layer in self.model.layers
        ]}


def plan_loss(engine: MinibatchEngine, gnn_cfg: GNNConfig, model: GNN, plan,
              H: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy of the seed logits of one plan."""
    V = engine.graph.num_vertices
    logits = engine.apply_model(model, gnn_cfg, plan, H)
    y = labels[plan.seed_ids.clamp(0, V - 1).long()]
    valid = plan.seed_ids != INVALID
    return masked_softmax_xent(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1), valid.reshape(-1)
    )


def step_loss(engine: MinibatchEngine, gnn_cfg: GNNConfig, store, labels: torch.Tensor,
              model: GNN, step: int):
    """Plan -> features -> logits -> xent for one step; ``(loss, plan)``."""
    plan = engine.plan_at(step)
    H = plan.gather_inputs(store)
    return plan_loss(engine, gnn_cfg, model, plan, H, labels), plan


def make_loss_fn(engine: MinibatchEngine, gnn_cfg: GNNConfig, store, labels):
    """Single mode-agnostic loss path: plan -> features -> logits -> xent."""
    labels = torch.as_tensor(np.asarray(labels)).to(engine.device)

    def loss_fn(model: GNN, step: int) -> torch.Tensor:
        return step_loss(engine, gnn_cfg, store, labels, model, step)[0]

    return loss_fn


def plan_grads(engine: MinibatchEngine, gnn_cfg: GNNConfig, model: GNN, plan,
               labels: torch.Tensor):
    """``(loss, grads)`` of one step's ``plan``: the input gather, the
    logits, the masked mean cross-entropy and its gradients (under the
    shard executor ``ShardRunner.plan_loss_and_grad``: this rank's plan,
    the global loss and the all-reduced gradients), in the spans
    ``gather``, ``forward`` and ``backward``."""
    if isinstance(engine.ex, ShardExecutor):
        return engine.shard_runner.plan_loss_and_grad(plan, model, gnn_cfg, engine.store,
                                                      labels)
    with span("gather"):
        H = plan.gather_inputs(engine.store)
    with span("forward"):
        loss = plan_loss(engine, gnn_cfg, model, plan, H, labels)
    with span("backward"):
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads


def step_program(engine: MinibatchEngine, gnn_cfg: GNNConfig, model: GNN, opt: AdamState,
                 labels: torch.Tensor, lr: float, with_plan: bool = False,
                 spans: bool = True) -> CompiledFunction:
    """The whole training step as one program keyed by the local batch:
    ``program(local_batch, engine.step_state(step))`` builds the step's
    plan (the body of ``engine.plan_at``'s program, or of the shard
    runner's, since a capture cannot hold another), gathers the inputs,
    takes the loss and its gradients (:func:`plan_grads`, the shard's
    exchanges and all-reduces included) and runs Adam, updating ``model``
    and ``opt`` in place.  It returns ``(loss,)``, or ``(loss, plan)`` with
    ``with_plan`` (a replay then copies the plan out).  A CUDA graph where
    ``engine.captures``; eager (the same body) otherwise.

    With ``spans`` the program records its stages (the spans ``plan``,
    ``gather``, ``forward``, ``backward``, ``adam``, under the shard
    executor ``all_reduce``, and each exchange's) and counts the valid
    input ids of its plans (``input_rows``) and its exchanges' bytes:
    :meth:`CompiledFunction.report` and :meth:`CompiledFunction.spans`
    read them.  ``spans=False`` captures the bare step, bit for bit the
    same arithmetic."""
    params = list(model.parameters())
    if isinstance(engine.ex, ShardExecutor):
        build = engine.shard_runner._build_at
    else:
        build = lambda state: engine._build_at(state)[0]  # noqa: E731

    def body(state):
        plan = build(state)
        count("input_rows", lambda: _valid_count(plan.input_ids))
        loss, grads = plan_grads(engine, gnn_cfg, model, plan, labels)
        with span("adam"):
            adam_update(params, grads, opt, lr=lr)
        return (loss.detach(), plan) if with_plan else (loss.detach(),)

    return CompiledFunction("train_step", body, capture=engine.captures, spans=spans)


def _valid_count(frontier_ids: torch.Tensor) -> torch.Tensor:
    """Valid ids of a frontier (each row sorted, INVALID-padded): those
    before the row's first INVALID, found by a binary search, so the count
    puts no mask the size of the frontier in the graph's memory pool."""
    end = torch.full((*frontier_ids.shape[:-1], 1), INVALID, dtype=frontier_ids.dtype,
                     device=frontier_ids.device)
    return torch.searchsorted(frontier_ids, end).sum()


def _stage_ms(spans: dict, stages: tuple) -> dict:
    """``{stage: ms}`` of one step's spans (``forward_backward`` is
    ``forward`` + ``backward``)."""
    ms = lambda name: spans[name]["ms"] if name in spans else 0.0  # noqa: E731
    return {s: ms("forward") + ms("backward") if s == "forward_backward" else ms(s)
            for s in stages}


def _exchanges(rec: dict) -> dict:
    """``{kind: (exchanges, bytes, ms)}`` of one step's exchange spans and
    byte counters: ``ids`` the id all-to-alls, ``forward`` the embeddings',
    ``backward`` the gradients' (the forward's slots again)."""
    spans, counters = rec["spans"], rec["counters"]
    out = {}
    for kind, tag in (("ids", "ids"), ("forward", "fwd"), ("backward", "bwd")):
        n = nbytes = 0
        ms = 0.0
        for l in range(MAX_LAYERS):
            s = spans.get(f"exchange.{tag}.l{l}")
            if s is None or not s["count"]:
                continue
            n, ms = n + s["count"], ms + s["ms"]
            if kind == "ids":
                nbytes += counters[f"exchange.id_bytes.l{l}"]
            else:
                fwd = spans[f"exchange.fwd.l{l}"]["count"]
                nbytes += counters[f"exchange.slot_bytes.l{l}"] // fwd * s["count"]
        out[kind] = (n, nbytes, ms)
    return out


def train_gnn(
    dataset,
    gnn_cfg: GNNConfig,
    tc: TrainConfig,
    model: Optional[GNN] = None,
    device: DeviceLike = None,
    stage_times: bool = False,
    on_step: Optional[Callable] = None,
) -> TrainResult:
    """Train for ``tc.num_steps`` steps on ``device`` (CUDA unless ``"cpu"``).

    ``model`` (e.g. from :func:`repro_torch.models.gnn.params_from_jax`)
    moves to the device and is trained in place; by default the weights
    are drawn from ``tc.seed``.  Each step is one call of
    :func:`step_program` (a graph replay on a card with the fused
    backend, under the shard executor when its group runs NCCL), and its
    wall ms to the loss's read goes to ``TrainResult.step_ms``.  With
    ``stage_times`` each step's spans are read after it (one copy to the
    host): ``TrainResult.stage_ms`` gets the ms of each of ``STAGES`` (of
    ``SHARD_STAGES`` under the shard executor; device ms on a card, host
    ms on the CPU) and, cooperative, ``TrainResult.exchanges`` the step's
    all-to-alls.  ``on_step(step, plan)`` sees each step's plan (an
    output of the program where it runs).  Under ``executor="shard"``
    every rank of the process group calls this; the device is then the
    rank's own (``cuda:{LOCAL_RANK % device_count}`` unless ``"cpu"``)
    and ``losses`` the global losses.
    """
    engine = MinibatchEngine.from_config(
        dataset.graph, tc.engine_config(gnn_cfg.num_layers), dataset=dataset,
        device=device,
    )
    dev = engine.device
    stages = SHARD_STAGES if isinstance(engine.ex, ShardExecutor) else STAGES
    if model is None:
        model = init_gnn(gnn_cfg, tc.seed, device=dev)
    model = model.to(dev)
    opt = adam_init(list(model.parameters()))
    labels = torch.as_tensor(np.asarray(dataset.labels)).to(dev)
    program = step_program(engine, gnn_cfg, model, opt, labels, tc.lr,
                           with_plan=on_step is not None)

    result = TrainResult(model=model)
    for step in range(tc.num_steps):
        t0 = time.perf_counter()
        loss, *plan = program(tc.local_batch, engine.step_state(step))
        plan = plan[0] if plan else None
        result.losses.append(float(loss.detach()))
        result.step_ms.append(1e3 * (time.perf_counter() - t0))
        if stage_times:
            rec = program.spans()[tc.local_batch]
            result.stage_ms.append(_stage_ms(rec["spans"], stages))
            if tc.mode == "cooperative":
                result.exchanges.append(_exchanges(rec))
        if on_step is not None:
            on_step(step, plan)
        if tc.eval_every and (step + 1) % tc.eval_every == 0:
            result.val_f1.append(evaluate(dataset, gnn_cfg, model, tc, device=dev))
    if program.capture:
        result.compiled = {"report": program.report(), "compiles": dict(program.compiles),
                           "captures": dict(program.captures)}
    return result


@torch.no_grad()
def evaluate(
    dataset, gnn_cfg: GNNConfig, model: GNN, tc: TrainConfig, split: str = "val",
    max_batches: int = 4, device: DeviceLike = None,
) -> float:
    """Micro-F1 with (independent) sampled neighborhoods -- Fig. 4 style."""
    dev = resolve_device(device)
    eval_engine = MinibatchEngine.from_config(
        dataset.graph,
        EngineConfig(
            mode="independent", num_pes=1, local_batch=tc.local_batch,
            num_layers=gnn_cfg.num_layers, sampler=tc.sampler,
            fanout=tc.fanout, schedule="iid", seed=tc.seed + 999,
        ),
        dataset=dataset, device=dev,
    )
    ids_all = {"val": dataset.val_ids, "test": dataset.test_ids}[split]
    labels = np.asarray(dataset.labels)
    preds, ys = [], []
    for i in range(max_batches):
        lo = i * tc.local_batch
        ids = ids_all[lo : lo + tc.local_batch]
        if len(ids) == 0:
            break
        seeds = frontier.pad_to(torch.from_numpy(np.asarray(ids, np.int32)), tc.local_batch)
        plan = eval_engine.build_plan(seeds, step=i)  # iid schedule @ seed+999
        h = plan.gather_inputs(eval_engine.store)
        logits = eval_engine.apply_model(model, gnn_cfg, plan, h)
        seed_ids = plan.seed_ids.cpu().numpy()
        valid = seed_ids != INVALID
        preds.append(logits.argmax(-1).cpu().numpy()[valid])
        ys.append(labels[seed_ids[valid]])
    return micro_f1(np.concatenate(preds), np.concatenate(ys))
