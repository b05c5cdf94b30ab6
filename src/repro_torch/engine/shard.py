"""Multi-process cooperative execution (port of ``repro.engine.shard``).

The JAX package runs one controller over a 1-D device mesh and the
per-PE bodies inside ``shard_map``.  Here every PE is a process, a rank
of a ``torch.distributed`` process group of ``num_pes`` ranks
(:func:`repro_torch.launch.make_coop_group`), and every rank runs the
per-PE code that :class:`SimExecutor` loops over, with a
:class:`ShardExecutor` whose exchange is ``all_to_all_single``: the
paper's Algorithm 1 on separate devices.

Layout contract
---------------
:meth:`ShardRunner.plan_at` returns this rank's own, unstacked
:class:`CoopMinibatch`: the shard that JAX keeps on each device.  Because
each rank draws the same ``(P, b)`` seed batch and RNG state and runs the
same per-PE code on its row, integer plan state is bit-identical to row
``p`` of the :class:`SimExecutor` plan; :meth:`ShardRunner.stack_plan`
all-gathers the leaves into the stacked ``(P, ...)`` layout to show it.
Floating-point loss and gradients agree to reduction order: each rank
sums its own seeds' cross-entropy and the shares are all-reduced, where
the simulation reduces one flat array.

Gradient sync is explicit in :meth:`ShardRunner.plan_loss_and_grad`: each
rank differentiates its share of the global masked mean (its CE sum over
the all-reduced valid count), then the loss shares and every gradient are
all-reduced (SUM) in one buffer.  The backward all-to-alls of Alg. 1
come from autograd through the exchange.

Compiled programs
-----------------
As the JAX package jits the ``shard_map`` build, the plan build is one
:class:`repro_torch.engine.compiled.CompiledFunction`
(:attr:`ShardRunner.plan_program`), keyed by the local batch, that reads
its step from the engine's :class:`repro_torch.core.rng.DeviceRNGState`
buffer; ``train_gnn`` runs the whole step as one more
(:func:`repro_torch.train.step_program`).  Each is one captured CUDA
graph on a card when the group runs NCCL (:attr:`ShardRunner.captures`):
NCCL's collectives are kernels on the card, recorded into the graph.
Gloo's run on the host and cannot be recorded, so under gloo, and on the
CPU, the same bodies run eagerly.  A replay launches the recorded
collectives, so every rank must have captured the same sequence of
collectives and must replay its graphs in the same order as the others:
the bodies never branch on the rank (the rank only picks this PE's seed
row), and every rank calls the same programs at the same steps.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cooperative import (
    CoopMinibatch,
    ShardExecutor,
    build_cooperative_minibatch,
)
from repro_torch.core.feature_loader import FeatureStore
from repro_torch.core.graph import INVALID
from repro_torch.core.rng import DeviceRNGState
from repro_torch.engine.compiled import CompiledFunction
from repro_torch.train.metrics import masked_softmax_xent_parts
from repro_torch.utils.spans import span

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.engine.engine import MinibatchEngine


@dataclass
class ShardRunner:
    """Cooperative engine bound to a process group; one PE per rank.

    Its programs (:attr:`plan_program`, and the train step that
    ``train_gnn`` builds on it) record the rank's collectives into CUDA
    graphs under NCCL.  The contract that makes their replays safe: every
    rank captures the same sequence of collectives (no body branches on
    the rank) and replays the same programs in the same order, so the
    recorded all-to-alls and all-reduces meet in lockstep; a rank that
    replays alone would wait on its peers until the group times out."""

    engine: "MinibatchEngine"
    ex: ShardExecutor

    @classmethod
    def for_engine(cls, engine: "MinibatchEngine", group=None) -> "ShardRunner":
        cfg = engine.config
        if cfg.mode != "cooperative":
            raise ValueError(
                "ShardRunner needs a cooperative engine; independent mode is plain "
                "data parallelism (no all-to-all)"
            )
        if not isinstance(engine.ex, ShardExecutor):
            raise ValueError(
                f"engine was built with executor={cfg.executor!r}; construct it with "
                "executor='shard'"
            )
        ex = engine.ex if group is None else dataclasses.replace(engine.ex, group=group)
        size = dist.get_world_size(ex.group)
        if size != cfg.num_pes:
            raise ValueError(f"process group has {size} ranks, engine expects {cfg.num_pes}")
        return cls(engine=engine, ex=ex)

    @property
    def rank(self) -> int:
        """This process's PE."""
        return dist.get_rank(self.ex.group)

    # ------------------------------------------------------------------
    # Per-PE plan construction
    # ------------------------------------------------------------------
    def plan_at(self, step: int) -> CoopMinibatch:
        """This rank's cooperative plan for ``step``: row ``rank`` of the
        step's seed batch under the shared RNG state, built with id
        all-to-alls between the ranks.  Bit-identical to row ``rank`` of
        the SimExecutor ``plan_at``.  A replay of :attr:`plan_program`
        where :attr:`captures`; the call does not wait for the device."""
        eng = self.engine
        return self.plan_program(eng.config.local_batch, eng.step_state(step))

    def _build_at(self, state: DeviceRNGState) -> CoopMinibatch:
        """The body of :attr:`plan_program`: this rank's seed row of the
        step whose state the buffer holds, and its plan (the span ``plan``)."""
        eng, cfg = self.engine, self.engine.config
        with span("plan"):
            seeds = eng._seed_draw(state)[self.rank]
            return build_cooperative_minibatch(
                eng.graph, eng.sampler, eng.part, seeds, state, cfg.num_layers, eng.caps,
                self.ex, backend=cfg.plan_backend,
            )

    @property
    def captures(self) -> bool:
        """Whether this rank's programs record CUDA graphs: a card, the
        fused backend and an NCCL group (gloo's collectives run on the
        host).  The configuration alone decides."""
        eng = self.engine
        return (eng.device.type == "cuda" and eng.config.plan_backend == "fused"
                and dist.get_backend(self.ex.group) == "nccl")

    @cached_property
    def plan_program(self) -> CompiledFunction:
        """``plan_at``'s program, keyed by the local batch: one CUDA graph
        of :meth:`_build_at` (the id all-to-alls included) serves every
        step of the schedule, its spans recorded."""
        return CompiledFunction("shard.plan_at", self._build_at, capture=self.captures,
                                spans=True)

    def stack_plan(self, plan: CoopMinibatch) -> CoopMinibatch:
        """Every rank's plan in the stacked ``(P, ...)`` layout (an
        all-gather per leaf, on every rank), for checks and ``plan_stats``."""
        P = self.engine.config.num_pes

        def gather(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if t is None:
                return None
            flat = t.contiguous()
            flat = flat.view(torch.uint8) if t.dtype == torch.bool else flat
            out = [torch.empty_like(flat) for _ in range(P)]
            dist.all_gather(out, flat, group=self.ex.group)
            out = torch.stack(out)
            return out.view(torch.bool) if t.dtype == torch.bool else out

        layers = tuple(
            dataclasses.replace(layer, **{
                f.name: gather(getattr(layer, f.name)) for f in dataclasses.fields(layer)
            })
            for layer in plan.layers
        )
        return CoopMinibatch(layers=layers, input_ids=gather(plan.input_ids),
                             seed_ids=gather(plan.seed_ids))

    # ------------------------------------------------------------------
    # Training-step pieces (loss + explicitly all-reduced gradients)
    # ------------------------------------------------------------------
    def loss_and_grad(self, model, gnn_cfg, store, labels: torch.Tensor, step: int):
        """``(loss, grads, plan)`` of one step on this rank: :meth:`plan_at`,
        then :meth:`plan_loss_and_grad`."""
        plan = self.plan_at(step)
        loss, grads = self.plan_loss_and_grad(plan, model, gnn_cfg, store, labels)
        return loss, grads, plan

    def plan_loss_and_grad(self, plan: CoopMinibatch, model, gnn_cfg, store,
                           labels: torch.Tensor):
        """``(loss, grads)`` of this rank's ``plan``.

        Gathers the *owned* input rows from ``store`` (the ``gather``
        kernel on a card), runs the cooperative forward (all-to-all
        redistribution between layers), differentiates this rank's share
        of the global masked-mean CE, then all-reduces the loss shares and
        gradients.  ``loss`` is the global loss and ``grads`` the global
        gradients, equal on every rank; the loss semantics are the
        SimExecutor's (the same masked mean over the same B = b·P seed
        rows).  The spans ``gather``, ``forward``, ``backward`` and
        ``all_reduce`` mark its stages.  No host sync, so a captured train
        step holds it (:func:`repro_torch.train.step_program`).
        """
        from repro_torch.models.gnn import gnn_apply_cooperative

        eng = self.engine
        V = eng.graph.num_vertices
        with span("gather"):
            H = plan.gather_inputs(store)
        with span("forward"):
            logits = gnn_apply_cooperative(model, gnn_cfg, self.ex, plan.layers, H,
                                           eng.caps.tilde_caps)
            y = labels[plan.seed_ids.clamp(0, V - 1).long()]
            s, n = masked_softmax_xent_parts(logits, y, plan.seed_ids != INVALID)
            dist.all_reduce(n, group=self.ex.group)
            # this rank's share of the global masked mean: CE sum over the
            # *global* valid count; the sum of the shares is the global mean
            share = s / n.clamp(min=1).to(s.dtype)
        params = list(model.parameters())
        with span("backward"):
            grads = torch.autograd.grad(share, params)
        with span("all_reduce"):
            flat = torch.cat([share.detach().reshape(1)] + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.ex.group)  # loss and gradient sync
        sizes = [p.numel() for p in params]
        grads = [g.view_as(p) for g, p in zip(flat[1:].split(sizes), params)]
        return flat[0], grads

    def make_loss_and_grad(self, gnn_cfg, features, labels) -> Callable:
        """``(model, step) -> (loss, grads)`` with the shard executor, as
        the JAX package's ``ShardRunner.make_loss_and_grad``: features and
        labels move to the engine's device once."""
        dev = self.engine.device
        as_tensor = lambda x: x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        store = FeatureStore(as_tensor(features).to(dev))
        labels = as_tensor(labels).to(dev)

        def loss_and_grad(model, step: int):
            loss, grads, _ = self.loss_and_grad(model, gnn_cfg, store, labels, step)
            return loss, grads

        return loss_and_grad
