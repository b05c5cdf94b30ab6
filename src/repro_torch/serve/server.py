"""The serving loop: coalesce -> build_plan -> gather -> forward -> scatter.

Port of ``repro.serve.server``.  ``GNNServer`` owns ONE
:class:`repro_torch.store.TieredFeatureStore` that stays warm across
consecutive coalesced batches: live request streams are highly
dependent (hot users, overlapping ego-nets), so the device CLOCK cache
keeps absorbing fetches batch after batch.

Clocking: arrivals carry *virtual* timestamps and the server advances its
clock by a per-batch **service time**.  With ``service_model="modeled"``
(default) that time comes from a bandwidth model (fixed overhead +
fetched-bytes/beta + flops/gamma), so admissions and latencies are
deterministic; ``"measured"`` uses the wall clock of the executed batch,
which ends in ``torch.cuda.synchronize()`` on a card.  Real compute runs
either way.  Every batch record splits its wall time into plan build,
feature gather and forward, each stage ended by a device sync, so the
three add up to it.  ``GNNServer.hot_path`` is the same plan -> gather
-> forward step with no sync of its own.

On one device, samplers draw per-vertex hash randomness and the forward
is row-wise, so a seed's prediction does not depend on which batch served
it; on the CPU it is bit-identical.  On a card cuBLAS may pick another
algorithm for another batch size, so there predictions agree within a
float32 tolerance.  ``serve_independent`` replays a trace one request at
a time as the baseline.

As the JAX package jits ``serve.plan`` and ``serve.forward`` per bucket
(``BucketedJit``), each bucket here has one program of each
(:class:`repro_torch.serve.coalesce.BucketGuard`): on a card with
``plan_backend="fused"`` a captured CUDA graph, replayed for every batch
of the bucket (the forward under ``no_grad``).  The tiered store's gather
runs between the two, as the reference's loop splits it, through its own
two programs keyed by the bucket (``clock_access`` and ``_assemble``,
captured on a card) and the host fill between them.  The CPU and the
reference backend run the same functions eagerly.  A bucket
fed a second shape signature raises ``RetraceError``, and
``ServeReport.compiles`` counts the signatures per bucket under the JAX
package's keys, ``"serve.plan"`` and ``"serve.forward"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.feature_loader import FeatureStore
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import EngineConfig
from repro_torch.models.gnn import GNN, GNNConfig, gnn_apply
from repro_torch.serve.coalesce import (
    BucketGuard,
    BucketLadder,
    CoalescedBatch,
    Coalescer,
    make_policy,
)
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.store.tiers import TieredFeatureStore

SERVICE_MODELS = ("modeled", "measured")


@dataclass(frozen=True)
class ServeConfig:
    """Everything that fixes a serving deployment (workload comes per-trace)."""

    num_layers: int = 2
    fanout: int = 5
    sampler: str = "labor0"
    seed: int = 0
    plan_backend: str = "reference"
    # admission / bucketing
    policy: str = "hybrid"            # max_batch | max_wait_ms | hybrid
    max_batch: int = 64               # admission cap == ladder top
    max_wait_ms: float = 20.0
    min_bucket: int = 8
    deadline_ms: float = 50.0         # default SLO stamped on traces
    # feature tier
    use_cache: bool = True
    cache_capacity: Optional[int] = None   # rows; None -> V // 4
    cache_ways: int = 8
    # virtual-clock service model (Table 1 constants; see docs/serving.md)
    service_model: str = "modeled"    # modeled | measured
    service_fixed_us: float = 150.0   # dispatch + kernel-launch overhead
    service_beta: float = 8e9         # host->device feature bytes/s
    service_gamma: float = 2e12       # effective train-free flop/s

    def __post_init__(self):
        if self.service_model not in SERVICE_MODELS:
            raise ValueError(
                f"service_model must be one of {SERVICE_MODELS}, "
                f"got {self.service_model!r}"
            )
        if self.min_bucket > self.max_batch:
            raise ValueError("min_bucket must be <= max_batch")


@dataclass(frozen=True)
class ServedRequest:
    """Per-request accounting: which batch served it and when."""

    request: Request
    t_dispatch: float
    t_complete: float
    batch_index: int
    bucket: int
    pred: np.ndarray          # (num_classes,) seed logits

    @property
    def latency_ms(self) -> float:
        return 1e3 * (self.t_complete - self.request.t_arrival)

    @property
    def met_deadline(self) -> bool:
        return self.latency_ms <= self.request.deadline_ms


@dataclass(frozen=True)
class BatchRecord:
    """Per-batch accounting row."""

    index: int
    bucket: int
    num_requests: int
    num_unique: int
    t_dispatch: float
    service_ms: float         # virtual-clock service time
    wall_ms: float            # measured compute wall time (informational)
    plan_ms: float            # wall_ms split by stage, each ended by a sync
    gather_ms: float
    forward_ms: float
    fetched_rows: int         # host->device rows this batch pulled
    edges: int                # sampled edges across layers


@dataclass
class ServeReport:
    """Outcome of serving one trace: per-request + per-batch accounting."""

    served: list[ServedRequest] = field(default_factory=list)
    batches: list[BatchRecord] = field(default_factory=list)
    fetched_rows: int = 0
    requested_rows: int = 0
    cache_hits: int = 0
    compiles: dict = field(default_factory=dict)  # signatures per bucket

    def latencies_ms(self) -> np.ndarray:
        return np.asarray([s.latency_ms for s in self.served])

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(self.latencies_ms(), q))

    @property
    def slo_attainment(self) -> float:
        if not self.served:
            return 1.0
        return float(np.mean([s.met_deadline for s in self.served]))

    @property
    def throughput_rps(self) -> float:
        if not self.served:
            return 0.0
        t0 = min(s.request.t_arrival for s in self.served)
        t1 = max(s.t_complete for s in self.served)
        return len(self.served) / max(t1 - t0, 1e-9)

    def summary(self) -> dict:
        return {
            "requests": len(self.served),
            "batches": len(self.batches),
            "p50_ms": round(self.percentile_ms(50), 3),
            "p95_ms": round(self.percentile_ms(95), 3),
            "p99_ms": round(self.percentile_ms(99), 3),
            "slo_attainment": round(self.slo_attainment, 4),
            "throughput_rps": round(self.throughput_rps, 2),
            "fetched_rows": self.fetched_rows,
            "requested_rows": self.requested_rows,
            "mean_batch": round(
                float(np.mean([b.num_requests for b in self.batches])), 2
            ) if self.batches else 0.0,
        }


class GNNServer:
    """Coalescing inference server over one graph + model + feature tier.

    Runs on CUDA unless ``device="cpu"``: the graph, the model and the
    device cache tier live there, the full feature table stays in host
    memory.  ``model`` is a :class:`repro_torch.models.gnn.GNN`.
    """

    def __init__(
        self,
        graph,
        features,
        gnn_cfg: GNNConfig,
        model: GNN,
        cfg: ServeConfig = ServeConfig(),
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.gnn_cfg = gnn_cfg
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.ladder = BucketLadder.geometric(cfg.max_batch, cfg.min_bucket)
        base = EngineConfig(
            mode="independent", num_pes=1, local_batch=cfg.max_batch,
            num_layers=cfg.num_layers, sampler=cfg.sampler,
            fanout=cfg.fanout, seed=cfg.seed, plan_backend=cfg.plan_backend,
        )
        self.coalescer = Coalescer(self.graph, base, self.ladder, self.device)
        features = np.asarray(features)
        self.store = None
        self.tiered = None
        if cfg.use_cache:
            cap = cfg.cache_capacity
            if cap is None:
                cap = max(cfg.cache_ways, graph.num_vertices // 4)
            cap -= cap % cfg.cache_ways
            self.tiered = TieredFeatureStore(
                features, capacity=cap, ways=cfg.cache_ways, device=self.device,
            )
        else:  # uncached: the whole table on the device
            self.store = FeatureStore(torch.from_numpy(features).to(self.device))
        # one RNG state serves every bucket: all engines share the seed
        self._rng = self.coalescer.engine_for(self.ladder.buckets[0]).step_state(0)
        capture = self.device.type == "cuda" and cfg.plan_backend == "fused"
        pool = torch.cuda.graph_pool_handle() if capture else None
        self._plan_guard = BucketGuard("serve.plan", self._build_plan, capture, pool)
        self._forward_guard = BucketGuard("serve.forward", self._apply, capture, pool)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the serving step's pieces: one program of each a bucket
    def _build_plan(self, seeds: torch.Tensor):
        return self.coalescer.engine_for(seeds.shape[0]).build_plan(seeds, rng=self._rng)

    def _apply(self, layers, H: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return gnn_apply(self.model, self.gnn_cfg, layers, H)

    def _plan(self, seeds):
        """The plan of one bucket of seeds (a host array or a tensor)."""
        if not isinstance(seeds, torch.Tensor):
            seeds = torch.from_numpy(np.asarray(seeds, np.int32))
        if seeds.device.type == "cpu" and self.device.type == "cuda":
            seeds = seeds.pin_memory()
        seeds = seeds.to(self.device, non_blocking=True)
        return self._plan_guard(seeds.shape[0], seeds.to(torch.int32))

    def _gather(self, plan) -> torch.Tensor:
        if self.tiered is not None:
            return self.tiered.gather(plan.input_ids, key=plan.seed_ids.shape[0])
        return self.store.gather(plan.input_ids)

    def _forward(self, plan, H: torch.Tensor) -> torch.Tensor:
        return self._forward_guard(plan.seed_ids.shape[0], plan.layers, H)

    def hot_path(self, seeds):
        """The full serving step for one bucket of seeds (plan -> gather ->
        forward), with no device sync of its own; returns ``(seed_ids,
        logits)`` on the device.

        Registered as a ``repro_torch.analysis`` trace entry: every
        same-bucket call must dispatch one op sequence (on a card, the
        bucket's two replays and the gather between them).  The gather goes
        through the server's feature tier (the CLOCK cache when
        ``use_cache``); the batch loop times the same three pieces.
        """
        plan = self._plan(seeds)
        return plan.seed_ids, self._forward(plan, self._gather(plan))

    # -- one batch ----------------------------------------------------------
    def _execute(self, batch: CoalescedBatch, index: int):
        """Run one coalesced batch; returns (record, seed_ids, logits)."""
        fetched_before = self.tiered.fetched_rows if self.tiered else 0
        self._sync()
        t0 = time.perf_counter()
        plan = self._plan(batch.seeds)
        self._sync()
        t1 = time.perf_counter()
        H = self._gather(plan)
        self._sync()
        t2 = time.perf_counter()
        logits = self._forward(plan, H)
        self._sync()
        t3 = time.perf_counter()
        wall_ms = 1e3 * (t3 - t0)

        stats = plan.stats()
        edges = sum(stats[f"E{l}"] for l in range(self.cfg.num_layers))
        if self.tiered is not None:
            fetched = self.tiered.fetched_rows - fetched_before
        else:
            fetched = self.store.count_fetched(plan.input_ids)
        service_ms = (
            wall_ms if self.cfg.service_model == "measured"
            else self._modeled_ms(fetched, edges)
        )
        rec = BatchRecord(
            index=index, bucket=batch.bucket,
            num_requests=len(batch.requests), num_unique=batch.num_unique,
            t_dispatch=batch.t_dispatch, service_ms=service_ms,
            wall_ms=wall_ms, plan_ms=1e3 * (t1 - t0), gather_ms=1e3 * (t2 - t1),
            forward_ms=1e3 * (t3 - t2), fetched_rows=fetched, edges=edges,
        )
        return rec, plan.seed_ids.cpu().numpy(), logits.cpu().numpy()

    def _modeled_ms(self, fetched_rows: int, edges: int) -> float:
        cfg, d = self.cfg, self.gnn_cfg.in_dim
        load_s = fetched_rows * d * 4 / cfg.service_beta
        flops = 2.0 * edges * d * self.gnn_cfg.hidden_dim
        return 1e3 * (cfg.service_fixed_us * 1e-6 + load_s
                      + flops / cfg.service_gamma)

    # -- trace loops --------------------------------------------------------
    def serve_trace(self, trace: list[Request]) -> ServeReport:
        """Serve a whole arrival trace under the configured policy."""
        policy = make_policy(
            self.cfg.policy, self.cfg.max_batch, self.cfg.max_wait_ms
        )
        queue = RequestQueue(trace)
        report = ServeReport()
        now = 0.0
        while queue.pending:
            reqs, t_disp = policy.admit(queue, now)
            batch = self.coalescer.coalesce(reqs, t_disp)
            rec, seed_ids, logits = self._execute(batch, len(report.batches))
            t_done = t_disp + rec.service_ms / 1e3
            report.batches.append(rec)
            for r in batch.requests:
                pos = int(np.searchsorted(seed_ids, r.seed))
                report.served.append(ServedRequest(
                    request=r, t_dispatch=t_disp, t_complete=t_done,
                    batch_index=rec.index, bucket=rec.bucket,
                    pred=logits[pos],
                ))
            now = t_done
        self._finalize(report)
        return report

    def serve_independent(self, trace: list[Request]) -> ServeReport:
        """Per-request baseline: same trace, every request its own batch.

        FIFO service at the smallest bucket — what a server without
        coalescing pays.  Uses the same cache configuration (fresh
        state), so the fetched-rows comparison isolates coalescing.
        """
        queue = RequestQueue(trace)
        report = ServeReport()
        now = 0.0
        while queue.pending:
            now = max(now, queue.peek_time())
            (req,) = queue.take(1)
            batch = self.coalescer.coalesce([req], now)
            rec, seed_ids, logits = self._execute(batch, len(report.batches))
            t_done = now + rec.service_ms / 1e3
            report.batches.append(rec)
            pos = int(np.searchsorted(seed_ids, req.seed))
            report.served.append(ServedRequest(
                request=req, t_dispatch=now, t_complete=t_done,
                batch_index=rec.index, bucket=rec.bucket, pred=logits[pos],
            ))
            now = t_done
        self._finalize(report)
        return report

    def _finalize(self, report: ServeReport) -> None:
        if self.tiered is not None:
            report.fetched_rows = self.tiered.fetched_rows
            report.requested_rows = self.tiered.requested
            report.cache_hits = self.tiered.hits
        else:
            report.fetched_rows = sum(b.fetched_rows for b in report.batches)
            report.requested_rows = report.fetched_rows
        report.compiles = {
            "serve.plan": dict(self._plan_guard.compiles),
            "serve.forward": dict(self._forward_guard.compiles),
        }
        self._plan_guard.assert_compiled_once_per_bucket()
        self._forward_guard.assert_compiled_once_per_bucket()
        if self.tiered is not None:
            self.tiered.access_program.assert_compiled_once_per_bucket()
            self.tiered.assemble_program.assert_compiled_once_per_bucket()

    def reset(self) -> None:
        """Fresh cache + counters (keeps the per-bucket signatures and
        programs: the cache is emptied in place)."""
        if self.tiered is not None:
            self.tiered.clear()
