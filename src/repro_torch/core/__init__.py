"""Core plan-building layer of the port: graph, RNG, frontiers, samplers,
partitions, independent and cooperative plans, and the LRU cache oracle.

The engine facade (``EngineConfig``, ``MinibatchEngine``,
``MinibatchStream``, ...) is re-exported lazily, as in the JAX package:
``from repro_torch.core import EngineConfig, LRUCache, MinibatchEngine``.
"""
from repro_torch.core.cache import CooperativeCacheArray, LRUCache
from repro_torch.core.cooperative import (
    CoopCapacityPlan,
    CoopLayer,
    CoopMinibatch,
    Executor,
    ShardExecutor,
    SimExecutor,
    build_cooperative_minibatch,
    plan_stats,
    redistribute,
)
from repro_torch.core.dependent import DependentSchedule, NestedSchedule
from repro_torch.core.feature_loader import FeatureStore
from repro_torch.core.graph import INVALID, Graph, GraphValidationError
from repro_torch.core.minibatch import (
    CapacityPlan,
    Minibatch,
    MinibatchLayer,
    build_minibatch,
    epoch_stats,
    layer_to_coo,
)
from repro_torch.core.partition import (
    Partition,
    cross_edge_ratio,
    make_partition,
    ownership_balance,
)
from repro_torch.core.rng import DependentRNG, RNGState
from repro_torch.core.samplers import (
    FullSampler,
    LaborSampler,
    LayerSample,
    NeighborSampler,
    RandomWalkSampler,
    make_sampler,
)

# engine facade (lazy re-exports, see __getattr__)
_ENGINE_EXPORTS = {
    "CacheConfig", "CapacityPolicy", "EngineConfig", "MinibatchEngine",
    "MinibatchStream", "Plan", "StreamItem",
}

__all__ = [
    "CapacityPlan", "CoopCapacityPlan", "CoopLayer", "CoopMinibatch",
    "CooperativeCacheArray", "DependentRNG", "DependentSchedule", "Executor",
    "FeatureStore", "FullSampler", "Graph", "GraphValidationError", "INVALID",
    "LRUCache", "LaborSampler", "LayerSample", "Minibatch", "MinibatchLayer",
    "NeighborSampler", "NestedSchedule", "Partition", "RNGState", "RandomWalkSampler",
    "ShardExecutor", "SimExecutor", "build_cooperative_minibatch", "build_minibatch",
    "cross_edge_ratio", "epoch_stats", "layer_to_coo", "make_partition", "make_sampler",
    "ownership_balance", "plan_stats", "redistribute", *sorted(_ENGINE_EXPORTS),
]


def __getattr__(name):
    # Lazy: repro_torch.engine imports this package, so a direct
    # top-of-file import here would be circular.
    if name in _ENGINE_EXPORTS:
        import repro_torch.engine as _engine

        return getattr(_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
