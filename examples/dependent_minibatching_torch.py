"""Dependent minibatching on the PyTorch port: cache locality vs kappa (§4.2).

    PYTHONPATH=src python examples/dependent_minibatching_torch.py [--device cpu]

The port's twin of ``dependent_minibatching.py``, at its configuration.
Shows the smoothed-RNG mechanism (A.7) directly -- per-vertex variates
drift slowly within a kappa window -- and the resulting LRU miss-rate
drop for vertex-embedding fetches, streaming plans through the
``MinibatchEngine``.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch.core import EngineConfig, LRUCache, MinibatchEngine
from repro_torch.core.rng import DependentRNG
from repro_torch.data import rmat_graph


def dependent_minibatching(scale: int = 12, num_ids: int = 4096,
                           corr_steps: tuple = (1, 16, 48, 64),
                           kappas: tuple = (1, 16, 64, None), local_batch: int = 128,
                           num_steps: int = 20, device=None) -> dict:
    """The demo at ``dependent_minibatching.py``'s constants; returns the
    correlations by step and the LRU miss rates by kappa."""
    graph = rmat_graph(scale=scale, edge_factor=8, max_degree=32, seed=0, device=device)

    # 1) the RNG mechanism: correlation across steps
    ids = torch.arange(num_ids, dtype=torch.int32, device=graph.device)
    r0 = DependentRNG(7, 64, 0).vertex_uniform(ids)
    corr = {}
    for step in corr_steps:
        r = DependentRNG(7, 64, step).vertex_uniform(ids)
        corr[step] = c = float(torch.corrcoef(torch.stack([r0, r]))[0, 1])
        print(f"corr(r_t @ step 0, step {step:3d}) = {c:+.3f}")

    # 2) LRU miss rate vs kappa: one engine per dependency window
    miss = {}
    for kappa in kappas:
        eng = MinibatchEngine.from_config(
            graph,
            EngineConfig(
                mode="independent", num_pes=1, local_batch=local_batch, num_layers=2,
                sampler="labor0", fanout=5, schedule="smoothed", kappa=kappa,
                seed=11,
            ),
            device=device,
        )
        cache = LRUCache(capacity=graph.num_vertices // 2)
        # stream() drives eng.plan_at(step): seed draw, RNG schedule and
        # sampling for each step
        for item in eng.stream(num_steps=num_steps):
            cache.access_batch(item.plan.input_ids.cpu().numpy().ravel())
        miss[kappa] = cache.miss_rate
        print(f"kappa={str(kappa):>4s}  LRU miss rate = {cache.miss_rate:.3f}")
    return dict(corr=corr, miss_rate=miss)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dependent_minibatching(device=ap.parse_args().device)
