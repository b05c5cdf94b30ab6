"""Core plan-building layer of the port: graph, RNG, frontiers, samplers, plans."""
from repro_torch.core.feature_loader import FeatureStore
from repro_torch.core.graph import INVALID, Graph, GraphValidationError
from repro_torch.core.minibatch import (
    CapacityPlan,
    Minibatch,
    MinibatchLayer,
    build_minibatch,
)
from repro_torch.core.rng import DependentRNG, RNGState
from repro_torch.core.samplers import LaborSampler, LayerSample, make_sampler

__all__ = [
    "CapacityPlan", "DependentRNG", "FeatureStore", "Graph",
    "GraphValidationError", "INVALID", "LaborSampler", "LayerSample",
    "Minibatch", "MinibatchLayer", "RNGState", "build_minibatch",
    "make_sampler",
]
