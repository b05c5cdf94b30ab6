"""``MinibatchEngine`` -- the minibatch-construction facade (port of
``repro.engine.engine``, independent mode).

``from_config`` derives the sampler, capacity plan and feature stores
from one :class:`EngineConfig`; ``build_plan`` samples a
:class:`repro_torch.core.Minibatch`.  Cooperative mode (the all-to-all
plan builder and executors) is the training slice's and raises
``NotImplementedError`` here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.feature_loader import FeatureStore
from repro_torch.core.graph import Graph
from repro_torch.core.minibatch import CapacityPlan, Minibatch, build_minibatch
from repro_torch.core.rng import DependentRNG
from repro_torch.core.samplers.base import Sampler, make_sampler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.config import EngineConfig
from repro_torch.store.tiers import TieredFeatureStore

_COOPERATIVE_TODO = (
    "cooperative minibatching is not ported to repro_torch yet "
    "(ROADMAP.md queue A, items A2-A3: the training slice)"
)


@dataclass
class MinibatchEngine:
    """One object that turns (graph, config) into sampled plans."""

    config: EngineConfig
    graph: Graph
    sampler: Sampler
    caps: CapacityPlan
    device: torch.device
    dataset: Optional[object] = None
    store: Optional[FeatureStore] = None
    tiered: Optional[TieredFeatureStore] = None

    @classmethod
    def from_config(
        cls, graph: Graph, config: EngineConfig, dataset=None,
        device: DeviceLike = None,
    ) -> "MinibatchEngine":
        """Derive sampler, capacities and feature stores from the config.

        Runs on CUDA unless ``device="cpu"``; the graph moves there.
        """
        cfg, cap = config, config.capacity
        if cfg.mode != "independent":
            raise NotImplementedError(_COOPERATIVE_TODO)
        dev = resolve_device(device)
        graph = graph.to(dev).validate()  # malformed CSR fails here
        V = graph.num_vertices
        sampler = make_sampler(cfg.sampler, fanout=cfg.fanout, backend=cfg.plan_backend)
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
            dataset=dataset, store=store, tiered=tiered,
        )

    def rng_at(self, step: int) -> DependentRNG:
        """RNG for ``step`` under the configured schedule (iid / smoothed)."""
        cfg = self.config
        if cfg.schedule == "nested":
            raise NotImplementedError(
                "the nested schedule is not ported to repro_torch yet "
                "(ROADMAP.md queue A, item A2)"
            )
        return DependentRNG(cfg.seed, cfg.effective_kappa, step)

    def build_plan(self, seeds, rng: Optional[DependentRNG] = None, step: int = 0) -> Minibatch:
        """Sample an L-layer plan from a 1-D seed frontier ``(b,)``.

        Bit-equal to ``repro.engine.MinibatchEngine.build_plan`` on the
        same seeds; ``config.plan_backend`` picks plain torch or the CUDA
        kernels, with identical outputs.
        """
        if rng is None:
            rng = self.rng_at(step)
        if not isinstance(seeds, torch.Tensor):
            seeds = torch.from_numpy(np.asarray(seeds, np.int32))
        seeds = seeds.to(device=self.device, dtype=torch.int32)
        if seeds.ndim != 1:
            raise NotImplementedError(
                "stacked (P, b) plans are not ported to repro_torch yet "
                "(ROADMAP.md queue A, items A2-A3: the training slice)"
            )
        cfg = self.config
        return build_minibatch(
            self.graph, self.sampler, seeds, rng, cfg.num_layers, self.caps,
            backend=cfg.plan_backend,
        )

    def gather_features(self, plan: Minibatch) -> torch.Tensor:
        """Input-layer embeddings for ``plan`` (through the cache if configured)."""
        if self.tiered is not None:
            return self.tiered.gather(plan.input_ids)
        if self.store is None:
            raise ValueError("engine has no feature store; construct with a dataset")
        return plan.gather_inputs(self.store)
