"""Engine configuration (a copy of ``repro.engine.config``).

One :class:`EngineConfig` pins a minibatching pipeline: mode, sampler,
layer/fanout budget, capacity policy, dependency schedule, partition,
executor, plan-construction backend and the tiered feature cache.
Configurations are interchangeable between the two packages; the port
runs both modes on the stacked-PE ``executor="sim"``, and cooperative mode
also on ``executor="shard"``, one PE per rank of a ``torch.distributed``
process group.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Optional

MODES = ("independent", "cooperative")
SCHEDULES = ("iid", "smoothed", "nested")
EXECUTORS = ("sim", "shard")
PLAN_BACKENDS = ("reference", "fused")

_UNSET = object()  # sentinel distinguishing "not passed" for legacy kwargs


@dataclass(frozen=True)
class CapacityPolicy:
    """Safety factors feeding the geometric capacity bounds (Thm 3.2).

    Defaults match ``CapacityPlan.geometric`` / ``CoopCapacityPlan.geometric``
    so engine-built plans are bit-identical to hand-built ones.
    """

    safety: float = 1.25          # independent frontier growth slack
    coop_safety: float = 1.5      # cooperative owned/request frontier slack
    bucket_safety: float = 2.5    # per-peer A2A bucket slack
    round_to: int = 8


@dataclass(frozen=True)
class CacheConfig:
    """Tiered feature store (repro_torch.store): device CLOCK cache per PE in
    front of the host feature tier.  ``capacity=None`` defaults to
    ``V // 4`` rows at engine construction."""

    enabled: bool = False
    capacity: Optional[int] = None  # rows per PE
    ways: int = 8

    def __post_init__(self):
        if self.ways < 1:
            raise ValueError("cache_ways must be >= 1")
        if self.capacity is not None and self.capacity < self.ways:
            raise ValueError("cache_capacity must be >= cache_ways")


@dataclass(frozen=True)
class EngineConfig:
    """Declarative spec for a :class:`repro_torch.engine.MinibatchEngine`."""

    mode: str = "independent"            # independent | cooperative
    num_pes: int = 1                     # P; global batch = local_batch * P
    local_batch: int = 64                # b
    num_layers: int = 2                  # L
    sampler: str = "labor0"              # ns | labor0 | labor* | rw | full
    fanout: int = 10
    schedule: str = "iid"                # iid | smoothed | nested
    kappa: Optional[int] = 1             # dependency window (None = infinite)
    partition: str = "hash"              # hash | block | bfs (cooperative only)
    executor: str = "sim"                # sim | shard (cooperative only)
    axis_name: str = "data"              # mesh axis in the JAX package (unused here)
    seed: int = 0
    partition_seed: Optional[int] = None  # defaults to ``seed``
    capacity: CapacityPolicy = field(default_factory=CapacityPolicy)
    # how plan construction runs: "reference" keeps the plain
    # sort/searchsorted frontier algebra; "fused" routes the hot loop
    # through the CUDA kernels (unique_compact / frontier_gather).
    # Bit-identical outputs either way.
    plan_backend: str = "reference"
    cache: Optional[CacheConfig] = None
    # deprecated flat aliases for ``cache`` — kept so old configs keep
    # constructing; emit DeprecationWarning when used
    feature_cache: object = _UNSET       # -> cache.enabled
    cache_capacity: object = _UNSET      # -> cache.capacity
    cache_ways: object = _UNSET          # -> cache.ways

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {self.schedule!r}"
            )
        if self.executor not in EXECUTORS:
            raise ValueError(
                f"executor must be one of {EXECUTORS}, got {self.executor!r}"
            )
        if self.plan_backend not in PLAN_BACKENDS:
            raise ValueError(
                f"plan_backend must be one of {PLAN_BACKENDS}, "
                f"got {self.plan_backend!r}"
            )
        if self.num_pes < 1 or self.local_batch < 1 or self.num_layers < 1:
            raise ValueError("num_pes, local_batch, num_layers must be >= 1")
        if self.schedule == "nested" and not self.kappa:
            raise ValueError("nested schedule requires a finite kappa >= 1")
        self._resolve_cache()

    def _resolve_cache(self):
        legacy = {
            "enabled": self.feature_cache,
            "capacity": self.cache_capacity,
            "ways": self.cache_ways,
        }
        given = {k: v for k, v in legacy.items() if v is not _UNSET}
        if self.cache is None:
            if given:
                warnings.warn(
                    "EngineConfig(feature_cache=..., cache_capacity=..., "
                    "cache_ways=...) is deprecated; pass "
                    "cache=CacheConfig(enabled=..., capacity=..., ways=...)",
                    DeprecationWarning,
                    stacklevel=3,
                )
            cache = CacheConfig(
                enabled=bool(given.get("enabled", False)),
                capacity=given.get("capacity", None),
                ways=given.get("ways", 8),
            )
            object.__setattr__(self, "cache", cache)
        else:
            for key, val in given.items():
                have = getattr(self.cache, key)
                want = bool(val) if key == "enabled" else val
                if have != want:
                    raise ValueError(
                        f"cache=CacheConfig(...) and the deprecated "
                        f"{'feature_cache' if key == 'enabled' else 'cache_' + key} "
                        f"kwarg disagree ({have!r} vs {want!r}); drop the "
                        f"legacy kwarg"
                    )
        # mirror the resolved values into the legacy attrs so
        # ``dataclasses.replace`` round-trips without re-warning and old
        # readers of ``cfg.feature_cache`` etc. keep working
        object.__setattr__(self, "feature_cache", self.cache.enabled)
        object.__setattr__(self, "cache_capacity", self.cache.capacity)
        object.__setattr__(self, "cache_ways", self.cache.ways)

    @property
    def global_batch(self) -> int:
        return self.local_batch * self.num_pes

    @property
    def effective_kappa(self) -> Optional[int]:
        """RNG dependency window: iid forces κ=1 (fresh seed every step)."""
        return 1 if self.schedule == "iid" else self.kappa

    def with_mode(self, mode: str) -> "EngineConfig":
        """Same pipeline, other minibatching mode — the paper's controlled
        comparison at identical global batch size (§4.3)."""
        return replace(self, mode=mode)
