"""Minibatching engine of the port: one facade from (graph, config) to plans.

    cfg = EngineConfig(mode="cooperative", num_pes=4, local_batch=64,
                       num_layers=3, sampler="labor0", fanout=10,
                       schedule="smoothed", kappa=16, plan_backend="fused")
    engine = MinibatchEngine.from_config(graph, cfg, dataset=ds)  # on CUDA
    plan = engine.plan_at(step)
    for item in engine.stream(num_steps=16, fetch_features=True):
        H = item.features                                       # through the cache
"""
from repro_torch.engine.config import CacheConfig, CapacityPolicy, EngineConfig
from repro_torch.engine.engine import MinibatchEngine
from repro_torch.engine.plan import Plan
from repro_torch.engine.stream import MinibatchStream, StreamItem

__all__ = ["CacheConfig", "CapacityPolicy", "EngineConfig", "MinibatchEngine",
           "MinibatchStream", "Plan", "StreamItem"]
