"""Minibatching engine of the port: one facade from (graph, config) to plans.

    cfg = EngineConfig(local_batch=64, num_layers=2, sampler="labor0",
                       fanout=5, plan_backend="fused")
    engine = MinibatchEngine.from_config(graph, cfg)          # on CUDA
    plan = engine.build_plan(seeds)
"""
from repro_torch.engine.config import CacheConfig, CapacityPolicy, EngineConfig
from repro_torch.engine.engine import MinibatchEngine

__all__ = ["CacheConfig", "CapacityPolicy", "EngineConfig", "MinibatchEngine"]
