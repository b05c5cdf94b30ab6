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
the reference backend run the same body eagerly.  ``stage_times=True``
ends every stage with a device sync and records its wall time, which a
graph cannot do: it selects the eager :func:`train_step` (the plan still
a replay of ``engine.plan_at``'s program).

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

import dataclasses
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
    stage_ms: list = field(default_factory=list)  # per step {stage: ms}, if timed
    step_ms: list = field(default_factory=list)   # per step wall ms, to the loss read
    # the step program's capture per key (ms, pool bytes, launches a replay)
    # and its signatures per key; empty where the step ran eagerly
    compiled: dict = field(default_factory=dict)
    # shard executor, if timed: per step {kind: (exchanges, bytes, ms)} of
    # this rank's all-to-alls ("ids", "forward", "backward")
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
              model: GNN, step: int, mark: Callable = lambda: None):
    """Plan -> features -> logits -> xent for one step; ``(loss, plan)``.
    ``mark()`` is called after the plan and after the feature gather."""
    plan = engine.plan_at(step)
    mark()
    H = plan.gather_inputs(store)
    mark()
    return plan_loss(engine, gnn_cfg, model, plan, H, labels), plan


def make_loss_fn(engine: MinibatchEngine, gnn_cfg: GNNConfig, store, labels):
    """Single mode-agnostic loss path: plan -> features -> logits -> xent."""
    labels = torch.as_tensor(np.asarray(labels)).to(engine.device)

    def loss_fn(model: GNN, step: int) -> torch.Tensor:
        return step_loss(engine, gnn_cfg, store, labels, model, step)[0]

    return loss_fn


def plan_grads(engine: MinibatchEngine, gnn_cfg: GNNConfig, model: GNN, plan,
               labels: torch.Tensor, mark: Callable = lambda: None):
    """``(loss, grads)`` of one step's ``plan``: the input gather, the
    logits, the masked mean cross-entropy and its gradients (under the
    shard executor ``ShardRunner.plan_loss_and_grad``: this rank's plan,
    the global loss and the all-reduced gradients).  ``mark()`` ends the
    gather, the forward+backward and, under the shard executor, the
    all-reduce."""
    if isinstance(engine.ex, ShardExecutor):
        return engine.shard_runner.plan_loss_and_grad(plan, model, gnn_cfg, engine.store,
                                                      labels, mark)
    H = plan.gather_inputs(engine.store)
    mark()
    loss = plan_loss(engine, gnn_cfg, model, plan, H, labels)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    mark()
    return loss, grads


def train_step(engine: MinibatchEngine, gnn_cfg: GNNConfig, model: GNN, opt: AdamState,
               labels: torch.Tensor, step: int, lr: float, mark: Callable = lambda: None):
    """One training step: the plan, the input gather, loss and gradients,
    Adam; ``(loss, opt, plan)``.  ``mark()`` ends each of ``STAGES``, or of
    ``SHARD_STAGES`` under the shard executor (its plan is this rank's)."""
    plan = engine.plan_at(step)
    mark()
    loss, grads = plan_grads(engine, gnn_cfg, model, plan, labels, mark)
    opt = adam_update(list(model.parameters()), grads, opt, lr=lr)
    mark()
    return loss, opt, plan


def step_program(engine: MinibatchEngine, gnn_cfg: GNNConfig, model: GNN, opt: AdamState,
                 labels: torch.Tensor, lr: float, with_plan: bool = False) -> CompiledFunction:
    """The whole training step as one program keyed by the local batch:
    ``program(local_batch, engine.step_state(step))`` builds the step's
    plan (the body of ``engine.plan_at``'s program, or of the shard
    runner's, since a capture cannot hold another), gathers the inputs,
    takes the loss and its gradients (:func:`plan_grads`, the shard's
    exchanges and all-reduces included) and runs Adam, updating ``model``
    and ``opt`` in place.  It returns ``(loss,)``, or ``(loss, plan)`` with
    ``with_plan`` (a replay then copies the plan out).  A CUDA graph where
    ``engine.captures``; eager (the same body) otherwise."""
    params = list(model.parameters())
    if isinstance(engine.ex, ShardExecutor):
        build = engine.shard_runner._build_at
    else:
        build = lambda state: engine._build_at(state)[0]  # noqa: E731

    def body(state):
        plan = build(state)
        loss, grads = plan_grads(engine, gnn_cfg, model, plan, labels)
        adam_update(params, grads, opt, lr=lr)
        return (loss.detach(), plan) if with_plan else (loss.detach(),)

    return CompiledFunction("train_step", body, capture=engine.captures)


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
    wall ms to the loss's read goes to ``TrainResult.step_ms``.
    ``stage_times`` runs the eager :func:`train_step` instead, ends every
    stage with a sync and records its wall ms in ``TrainResult.stage_ms``
    (and, under the shard executor, each step's all-to-alls in
    ``TrainResult.exchanges``: their timing events cannot be recorded
    into a graph); ``on_step(step, plan)`` sees each step's plan (an
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
    shard = isinstance(engine.ex, ShardExecutor)
    stages = SHARD_STAGES if shard else STAGES
    log = None
    if shard and stage_times:
        log = []
        engine.ex = dataclasses.replace(engine.ex, log=log)
    if model is None:
        model = init_gnn(gnn_cfg, tc.seed, device=dev)
    model = model.to(dev)
    opt = adam_init(list(model.parameters()))
    labels = torch.as_tensor(np.asarray(dataset.labels)).to(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    program = None
    if not stage_times:
        program = step_program(engine, gnn_cfg, model, opt, labels, tc.lr,
                               with_plan=on_step is not None)

    result = TrainResult(model=model)
    for step in range(tc.num_steps):
        marks = [time.perf_counter()]

        def mark():
            if stage_times:
                sync()
                marks.append(time.perf_counter())

        if program is not None:
            loss, *plan = program(tc.local_batch, engine.step_state(step))
            plan = plan[0] if plan else None
        else:
            loss, opt, plan = train_step(engine, gnn_cfg, model, opt, labels, step, tc.lr,
                                         mark)
        result.losses.append(float(loss.detach()))
        result.step_ms.append(1e3 * (time.perf_counter() - marks[0]))
        if stage_times:
            result.stage_ms.append({
                s: 1e3 * (b - a) for s, a, b in zip(stages, marks, marks[1:])
            })
        if log is not None:
            result.exchanges.append({
                kind: (len(recs), sum(r.nbytes for r in recs), sum(r.ms() for r in recs))
                for kind in ("ids", "forward", "backward")
                for recs in [[r for r in log if r.kind == kind]]
            })
            log.clear()
        if on_step is not None:
            on_step(step, plan)
        if tc.eval_every and (step + 1) % tc.eval_every == 0:
            result.val_f1.append(evaluate(dataset, gnn_cfg, model, tc, device=dev))
    if program is not None and program.capture:
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
