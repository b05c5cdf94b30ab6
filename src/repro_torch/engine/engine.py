"""``MinibatchEngine`` -- the minibatch-construction facade (port of
``repro.engine.engine``).

The paper's central comparison (§3.1–§3.2, Fig. 7) runs *the same*
training computation under two minibatching modes at identical global
batch size.  ``from_config`` derives the sampler, capacity plan,
partition, executor and feature stores from one :class:`EngineConfig`;
``seed_batch``/``plan_at`` draw the step's seeds and build its plan;
``stream`` iterates over steps (:class:`MinibatchStream`); ``apply_model``
holds the one mode dispatch (per-PE apply vs all-to-all redistribution).

Dependency schedules (§3.2 + A.7): ``iid`` (fresh seed per step),
``smoothed`` (κ-window RNG interpolation) and ``nested`` (κ sub-batches
carved from one group batch under a frozen group RNG).

As the JAX package compiles ``plan_at`` into one program, the port
records it as one CUDA graph (:mod:`repro_torch.engine.compiled`) and
replays it every step: the seed draw and the sampling read the step from
one device buffer (:class:`repro_torch.core.rng.DeviceRNGState`: the two
seeds, ``cos``/``sin`` of the interpolation, the draw's key and the nested
sub-batch offset), which the host fills from pinned memory without a
sync.  With ``executor="shard"`` each rank's build is a program of its
own (:attr:`ShardRunner.plan_program`), captured when the group runs
NCCL.  The CPU, ``plan_backend="reference"`` and a gloo group run the
same device-state code eagerly.  Seed draws and plans are bit-equal
to the JAX package's on the CPU, and to the CPU run on a card.
``executor="shard"`` runs one PE per rank of a ``torch.distributed``
process group (:attr:`MinibatchEngine.shard_runner`,
:mod:`repro_torch.engine.shard`).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.cooperative import (
    CoopCapacityPlan,
    CoopMinibatch,
    Executor,
    ShardExecutor,
    SimExecutor,
    build_cooperative_minibatch,
)
from repro_torch.core.dependent import NestedSchedule
from repro_torch.core.feature_loader import FeatureStore
from repro_torch.core.graph import INVALID, Graph
from repro_torch.core.minibatch import CapacityPlan, build_minibatch
from repro_torch.core.partition import Partition, make_partition
from repro_torch.core.rng import _MASK32, DependentRNG, DeviceRNGState, RNGState, hash_u32, mix_int
from repro_torch.core.samplers.base import Sampler, make_sampler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.compiled import CompiledFunction
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.plan import Plan
from repro_torch.engine.stream import MinibatchStream
from repro_torch.launch.mesh import make_coop_group
from repro_torch.store.tiers import TieredFeatureStore
from repro_torch.utils.spans import host_span, span

_GOLDEN = 0x9E3779B9


def _hash_permute_rows(rows: torch.Tensor, z) -> torch.Tensor:
    """Row-wise hash-keyed permutation of an INVALID-padded pool table.

    Valid ids get uint32 keys (held in int64, clamped below the sentinel
    key) and sort by them; INVALID entries pin to the key maximum so
    padding stays at every row's tail.  The stable sort makes collisions
    deterministic, as the JAX package's stable argsort does.  ``z`` is a
    python int or a 0-d int64 tensor.
    """
    salt = torch.arange(rows.shape[0], dtype=torch.int64, device=rows.device)[:, None]
    key = hash_u32(rows, z, salt)
    key = torch.where(rows != INVALID, key.clamp(max=0xFFFFFFFE), 0xFFFFFFFF)
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.gather(rows, 1, order)


def _draw_key(x: int, base: int) -> int:
    """``_mix(x ^ base * 0x9E3779B9)`` on uint32 python ints."""
    return mix_int((x & _MASK32) ^ ((base * _GOLDEN) & _MASK32))


@dataclass
class MinibatchEngine:
    """One object that turns (graph, config) into sampled plans."""

    config: EngineConfig
    graph: Graph
    sampler: Sampler
    caps: Union[CapacityPlan, CoopCapacityPlan]
    device: torch.device
    ex: Optional[Executor] = None           # cooperative only
    part: Optional[Partition] = None        # cooperative only
    dataset: Optional[object] = None        # seeds come from the train split if set
    store: Optional[FeatureStore] = None
    tiered: Optional[TieredFeatureStore] = None

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_config(
        cls, graph: Graph, config: EngineConfig, dataset=None,
        device: DeviceLike = None,
    ) -> "MinibatchEngine":
        """Derive sampler, capacities, partition, executor and stores.

        Runs on CUDA unless ``device="cpu"``; the graph moves there.  A
        cooperative ``executor="shard"`` engine needs a running process
        group of ``num_pes`` ranks (:func:`repro_torch.launch.make_coop_group`)
        and runs on this rank's card (``cuda:{LOCAL_RANK % device_count}``)
        or the CPU.
        """
        cfg, cap = config, config.capacity
        shard = cfg.mode == "cooperative" and cfg.executor == "shard"
        if shard:  # one PE per rank; the rank's device comes with its group
            group, dev = make_coop_group(cfg.num_pes, device=device)
        else:
            dev = resolve_device(device)
        graph = graph.to(dev).validate()  # malformed CSR fails here
        V = graph.num_vertices
        sampler = make_sampler(cfg.sampler, fanout=cfg.fanout, backend=cfg.plan_backend)
        part, ex = None, None
        if cfg.mode == "cooperative":
            caps = CoopCapacityPlan.geometric(
                cfg.local_batch, cfg.num_layers, cfg.fanout, V, cfg.num_pes,
                safety=cap.coop_safety, bucket_safety=cap.bucket_safety,
                round_to=cap.round_to,
            )
            pseed = cfg.seed if cfg.partition_seed is None else cfg.partition_seed
            part = make_partition(cfg.partition, graph, cfg.num_pes, seed=pseed)
            ex = ShardExecutor(cfg.num_pes, group) if shard else SimExecutor(cfg.num_pes)
        else:
            caps = CapacityPlan.geometric(
                cfg.local_batch, cfg.num_layers, cfg.fanout, V,
                safety=cap.safety, round_to=cap.round_to,
            )
        store, tiered = None, None
        if dataset is not None:
            feats = np.asarray(dataset.features)
            store = FeatureStore(torch.from_numpy(feats).to(dev))
            if cfg.cache.enabled:
                rows = cfg.cache.capacity
                if rows is None:
                    rows = max(cfg.cache.ways, V // 4)
                rows -= rows % cfg.cache.ways  # CLOCK sets need capacity % ways == 0
                tiered = TieredFeatureStore(
                    feats, capacity=rows, ways=cfg.cache.ways,
                    num_pes=cfg.num_pes, device=dev,
                )
        return cls(
            config=cfg, graph=graph, sampler=sampler, caps=caps, device=dev,
            ex=ex, part=part, dataset=dataset, store=store, tiered=tiered,
        )

    # ------------------------------------------------------------------
    # RNG schedule
    # ------------------------------------------------------------------
    def _nested_sched(self) -> NestedSchedule:
        cfg = self.config
        return NestedSchedule(
            base_seed=cfg.seed, kappa=cfg.kappa, sub_batch_size=cfg.local_batch
        )

    def rng_at(self, step: int) -> DependentRNG:
        """RNG for ``step`` under the configured schedule."""
        cfg = self.config
        if cfg.schedule == "nested":
            return self._nested_sched().rng_for_group(step)  # frozen per group
        return DependentRNG(cfg.seed, cfg.effective_kappa, step)

    def rng_state(self, step: int) -> RNGState:
        """The step's RNG state (seeds and interpolation coefficient), equal
        to what ``repro``'s traced ``rng_state`` computes."""
        return self.rng_at(step).state

    # ------------------------------------------------------------------
    # Seed batches
    # ------------------------------------------------------------------
    def _seed_pool(self) -> np.ndarray:
        if self.dataset is not None:
            return np.asarray(self.dataset.train_ids)
        return np.arange(self.graph.num_vertices, dtype=np.int32)

    @cached_property
    def _owned_pools(self) -> list[np.ndarray]:
        pool = self._seed_pool()
        owner = self.part.owner.cpu().numpy()
        return [pool[owner[pool] == p] for p in range(self.config.num_pes)]

    @cached_property
    def _seed_rows(self) -> torch.Tensor:
        """(R, C) int32 device pool table, INVALID-padded rows.

        Cooperative: row p = PE p's owned train ids.  Independent nested:
        the global pool replicated P times (each PE permutes its own
        copy).  Independent otherwise: ONE global row -- the first P·b
        entries of its per-step permutation are the global batch, which
        keeps the draw without replacement *across* PEs.
        """
        cfg = self.config
        P, b = cfg.num_pes, cfg.local_batch
        if cfg.mode == "cooperative":
            rows = self._owned_pools
        elif cfg.schedule == "nested":
            rows = [self._seed_pool()] * P
        else:
            rows = [self._seed_pool()]
        need = cfg.kappa * b if cfg.schedule == "nested" else (
            P * b if len(rows) == 1 else b
        )
        C = max(need, max(len(r) for r in rows))
        out = np.full((len(rows), C), np.int32(INVALID), np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = np.asarray(r, np.int32)
        return torch.from_numpy(out).to(self.device)

    def step_state(self, step: int) -> DeviceRNGState:
        """The step's RNG state, the seed draw's key and the nested
        sub-batch offset in one buffer on the engine's device
        (:class:`DeviceRNGState`), written without a device sync (the
        pinned upload; the host span ``engine.step_state`` while a profiler
        runs)."""
        cfg = self.config
        step = int(step)
        if cfg.schedule == "nested":
            group, i = divmod(step, cfg.kappa)
            key, offset = _draw_key(group, cfg.seed), i * cfg.local_batch
        else:
            key, offset = _draw_key(step, cfg.seed), 0
        with host_span("engine.step_state"):
            return DeviceRNGState.pack(self.rng_state(step), key, offset, device=self.device)

    def _seed_draw(self, state: DeviceRNGState) -> torch.Tensor:
        """(P, b) int32 seed rows for the step of ``state``, on the device.

        Each draw is a hash-keyed permutation of the pool table under a
        per-(step-or-group, row) salt; pools smaller than the draw pad
        with INVALID.  A nested sub-batch is gathered at the state's
        offset (the reference's ``dynamic_slice_in_dim``).
        """
        cfg = self.config
        P, b = cfg.num_pes, cfg.local_batch
        rows = self._seed_rows
        perm = _hash_permute_rows(rows, state.key)
        if cfg.schedule == "nested":
            cols = state.offset + torch.arange(b, dtype=torch.int64, device=rows.device)
            return perm.index_select(1, cols)
        if rows.shape[0] == 1:
            return perm[0, : P * b].reshape(P, b)
        return perm[:, :b].contiguous()

    def _seed_batch(self, step: int) -> torch.Tensor:
        """(P, b) int32 seed rows for ``step``, on the engine's device."""
        return self._seed_draw(self.step_state(step))

    def seed_batch(self, step: int) -> np.ndarray:
        """(P, b) int32 seed rows for ``step`` (INVALID-padded short rows).

        The same bits as the seeds ``plan_at`` consumes, and as
        ``repro.engine.MinibatchEngine.seed_batch``.  Independent: P·b ids
        drawn from the global pool without replacement.  Cooperative: row
        p holds only vertices PE p owns.  Nested schedules carve b-sized
        sub-batches out of a κ·b group batch redrawn every κ steps.
        """
        return self._seed_batch(step).cpu().numpy()

    # ------------------------------------------------------------------
    # Plan construction
    # ------------------------------------------------------------------
    def build_plan(self, seeds, rng=None, step: int = 0) -> Plan:
        """Sample an L-layer plan from a seed frontier.

        ``seeds``: 1-D ``(b,)`` for a single independent plan or stacked
        ``(P, b)`` for per-PE plans (cooperative plans are always
        stacked).  ``rng`` (a :class:`DependentRNG` or :class:`RNGState`)
        defaults to the schedule's RNG at ``step``.  ``config.plan_backend``
        picks plain torch or the CUDA kernels, with identical outputs.
        """
        if rng is None:
            rng = self.rng_at(step)
        if not isinstance(seeds, torch.Tensor):
            seeds = torch.from_numpy(np.asarray(seeds, np.int32))
        seeds = seeds.to(device=self.device, dtype=torch.int32)
        cfg = self.config
        backend = cfg.plan_backend
        if cfg.mode == "cooperative":
            if isinstance(self.ex, ShardExecutor):
                raise ValueError(
                    "build_plan builds every PE's stacked plan in this process and "
                    "cannot host the shard executor's one-PE-per-rank exchange; use "
                    "plan_at (routed through shard_runner) or executor='sim'"
                )
            return build_cooperative_minibatch(
                self.graph, self.sampler, self.part, seeds, rng,
                cfg.num_layers, self.caps, self.ex, backend=backend,
            )
        build_one = lambda s: build_minibatch(
            self.graph, self.sampler, s, rng, cfg.num_layers, self.caps,
            backend=backend,
        )
        if seeds.ndim == 1:
            return build_one(seeds)
        return SimExecutor(seeds.shape[0]).pe(build_one, seeds)

    def plan_at(self, step: int) -> Plan:
        """The plan for ``step``: the seed draw, the schedule's RNG state and
        sampling, always in the stacked ``(P, b)`` layout -- identical to
        ``build_plan(seed_batch(step), rng=rng_state(step))``.  On a card
        with the fused backend it is one captured program replayed every
        step (:attr:`plan_program`); the call does not wait for the device.

        With ``executor="shard"`` each rank builds its own PE's plan (id
        all-to-alls between the ranks) and gets that unstacked plan, equal
        bit for bit to its row of the SimExecutor plan.
        """
        if isinstance(self.ex, ShardExecutor):
            return self.shard_runner.plan_at(step)
        return self.plan_and_seeds(step)[0]

    def plan_and_seeds(self, step: int) -> tuple[Plan, torch.Tensor]:
        """``(plan_at(step), the step's (P, b) device seed rows)`` with no
        device sync (one program run, two under the shard executor)."""
        if isinstance(self.ex, ShardExecutor):
            return self.shard_runner.plan_at(step), self._seed_batch(step)
        return self.plan_program(self.config.local_batch, self.step_state(step))

    def _build_at(self, state: DeviceRNGState) -> tuple[Plan, torch.Tensor]:
        """The body of :attr:`plan_program`: the seed draw and the plan of
        the step whose state the buffer holds (the span ``plan``)."""
        with span("plan"):
            seeds = self._seed_draw(state)
            return self.build_plan(seeds, rng=state), seeds

    @property
    def captures(self) -> bool:
        """Whether this engine's programs record CUDA graphs: a card and the
        fused backend, and under the shard executor an NCCL group
        (:attr:`ShardRunner.captures`: gloo's collectives run on the host).
        The configuration alone decides; see
        :mod:`repro_torch.engine.compiled`."""
        if isinstance(self.ex, ShardExecutor):
            return self.shard_runner.captures
        return self.device.type == "cuda" and self.config.plan_backend == "fused"

    @cached_property
    def plan_program(self) -> CompiledFunction:
        """``plan_at``'s program, keyed by the local batch: one CUDA graph
        of :meth:`_build_at` serves every step of the schedule, its spans
        recorded (:mod:`repro_torch.utils.spans`)."""
        return CompiledFunction("plan_at", self._build_at, capture=self.captures, spans=True)

    @cached_property
    def shard_runner(self):
        """Multi-process runner (``executor="shard"`` only): binds this
        engine to its process group and runs the per-rank plan build and
        the train-step loss and gradient sync."""
        from repro_torch.engine.shard import ShardRunner

        return ShardRunner.for_engine(self)

    # ------------------------------------------------------------------
    # Feature loading -- through the tiered store when configured
    # ------------------------------------------------------------------
    def gather_features(self, plan: Plan) -> torch.Tensor:
        """Input-layer embeddings for ``plan`` (through the cache if configured)."""
        if self.tiered is not None:
            return self.tiered.gather(plan.input_ids)
        if self.store is None:
            raise ValueError("engine has no feature store; construct with a dataset")
        return plan.gather_inputs(self.store)

    # ------------------------------------------------------------------
    # Model application -- the one remaining mode dispatch
    # ------------------------------------------------------------------
    def apply_model(self, model, gnn_cfg, plan: Plan, H: torch.Tensor) -> torch.Tensor:
        """Seed logits from input embeddings ``H = plan.gather_inputs(...)``.

        Independent: per-PE bipartite compute (one apply per PE when
        stacked).  Cooperative: Alg. 1 forward -- all-to-all
        redistribution between layers; the backward all-to-alls come from
        autograd.
        """
        from repro_torch.models.gnn import (
            gnn_apply,
            gnn_apply_cooperative,
            gnn_apply_stacked,
        )

        if isinstance(plan, CoopMinibatch):
            return gnn_apply_cooperative(
                model, gnn_cfg, self.ex, plan.layers, H, self.caps.tilde_caps
            )
        if plan.input_ids.ndim > 1:  # stacked (P, ...) independent plans
            return gnn_apply_stacked(model, gnn_cfg, plan.layers, H)
        return gnn_apply(model, gnn_cfg, plan.layers, H)

    # ------------------------------------------------------------------
    # Streaming
    # ------------------------------------------------------------------
    def stream(
        self,
        num_steps: int,
        start_step: int = 0,
        prefetch: int = 2,
        fetch_features: bool = False,
    ) -> MinibatchStream:
        """Iterator over :class:`StreamItem` (plan, rng, seeds, step and,
        with ``fetch_features``, the input features through the tiered
        store when configured), ``prefetch`` items built ahead (see
        :class:`MinibatchStream`)."""
        return MinibatchStream(self, num_steps, start_step, prefetch, fetch_features)
