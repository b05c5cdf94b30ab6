"""Core plan-building layer of the port: graph, RNG, frontiers, samplers,
partitions, independent and cooperative plans."""
from repro_torch.core.cooperative import (
    CoopCapacityPlan,
    CoopLayer,
    CoopMinibatch,
    Executor,
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

__all__ = [
    "CapacityPlan", "CoopCapacityPlan", "CoopLayer", "CoopMinibatch",
    "DependentRNG", "DependentSchedule", "Executor", "FeatureStore", "FullSampler",
    "Graph", "GraphValidationError", "INVALID", "LaborSampler", "LayerSample",
    "Minibatch", "MinibatchLayer", "NeighborSampler", "NestedSchedule", "Partition",
    "RNGState", "RandomWalkSampler", "SimExecutor", "build_cooperative_minibatch",
    "build_minibatch", "cross_edge_ratio", "epoch_stats", "layer_to_coo",
    "make_partition", "make_sampler", "ownership_balance", "plan_stats", "redistribute",
]
