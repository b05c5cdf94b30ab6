"""Empirical validation harness for Theorems 3.1 / 3.2 / 3.3 (port of
``repro.core.theory``).

Measures ``E[|S^l|]`` over random seed batches as a function of batch
size and checks:

* work monotonicity  -- E[|S^l|]/|S^0| nonincreasing in |S^0| (Thm 3.1),
* concavity          -- discrete second differences of E[|S^l|] <= 0
                        (Thm 3.2, up to sampling noise),
* density            -- E[|S_E|]/|S| of the vertex-induced subgraph is
                        nondecreasing in |S| (Thm 3.3).

Seeds come from the same numpy draws as the JAX harness, and each plan
is bit-equal to the one the JAX package's ``build_minibatch`` compiles
under ``jax.jit`` with the RNG state traced (``plan_at``'s semantics).
The JAX harness itself builds its plans op by op, where the NS
sampler's edge variates can differ from the compiled ones in the last
bit; its counts still equal the port's on the cases
``tests/test_torch_theory.py`` runs.  The plans are built on the graph's
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph import INVALID, Graph
from repro_torch.core.minibatch import CapacityPlan, build_minibatch
from repro_torch.core.rng import DependentRNG
from repro_torch.core.samplers.base import Sampler


@dataclass
class WorkCurve:
    batch_sizes: list[int]
    expected_sl: list[float]     # E[|S^L|]
    work_per_seed: list[float]   # E[|S^L|] / |S^0|


def sample_work_curve(
    graph: Graph,
    sampler: Sampler,
    batch_sizes: list[int],
    num_layers: int = 3,
    trials: int = 8,
    seed: int = 0,
    fanout_for_caps: int = 10,
):
    """Yield ``(batch size, trial, minibatch)`` for every plan the work
    curve measures, in the JAX harness's order of numpy draws."""
    rng_np = np.random.default_rng(seed)
    for bs in batch_sizes:
        caps = CapacityPlan.geometric(bs, num_layers, fanout_for_caps, graph.num_vertices)
        for t in range(trials):
            seeds = rng_np.choice(graph.num_vertices, size=bs, replace=False)
            rng = DependentRNG(base_seed=seed + 101 * t, kappa=1, step=0)
            seeds = torch.from_numpy(seeds.astype(np.int32)).to(graph.device)
            yield bs, t, build_minibatch(graph, sampler, seeds, rng, num_layers, caps)


def measure_work_curve(
    graph: Graph,
    sampler: Sampler,
    batch_sizes: list[int],
    num_layers: int = 3,
    trials: int = 8,
    seed: int = 0,
    fanout_for_caps: int = 10,
) -> WorkCurve:
    sizes = [int(mb.num_inputs) for _, _, mb in sample_work_curve(
        graph, sampler, batch_sizes, num_layers, trials, seed, fanout_for_caps)]
    e_sl = [float(np.mean(sizes[i * trials:(i + 1) * trials])) for i in range(len(batch_sizes))]
    return WorkCurve(list(batch_sizes), e_sl, [e / bs for e, bs in zip(e_sl, batch_sizes)])


def is_monotone_nonincreasing(xs: list[float], tol: float = 0.03) -> bool:
    """Allow `tol` relative sampling noise between consecutive points."""
    return all(b <= a * (1 + tol) for a, b in zip(xs, xs[1:]))


def is_concave(batch_sizes: list[int], values: list[float], tol: float = 0.05) -> bool:
    """Discrete concavity check on (possibly non-uniform) grid."""
    slopes = [
        (v2 - v1) / (b2 - b1)
        for (b1, v1), (b2, v2) in zip(
            zip(batch_sizes, values), zip(batch_sizes[1:], values[1:])
        )
    ]
    scale = max(abs(s) for s in slopes) + 1e-9
    return all(s2 <= s1 + tol * scale for s1, s2 in zip(slopes, slopes[1:]))


def measure_density_curve(
    graph: Graph, batch_sizes: list[int], trials: int = 8, seed: int = 0
) -> tuple[list[int], list[float]]:
    """Subgraph-sampling density E[|S_E|]/|S| (Thm 3.3 setting).

    Vertex-induced subgraph over a uniform vertex subset S.
    """
    indptr = graph.indptr.cpu().numpy()
    indices = graph.indices.cpu().numpy()
    dst = np.repeat(np.arange(graph.num_vertices), np.diff(indptr))
    rng = np.random.default_rng(seed)
    density = []
    for bs in batch_sizes:
        vals = []
        for _ in range(trials):
            S = rng.choice(graph.num_vertices, size=bs, replace=False)
            mask = np.zeros(graph.num_vertices, bool)
            mask[S] = True
            e = int((mask[indices] & mask[dst]).sum())
            vals.append(e / bs)
        density.append(float(np.mean(vals)))
    return list(batch_sizes), density


def unique_vertex_fraction(mb_input_ids, per_pe: bool) -> float:
    """|T^l|-style overlap diagnostic: fraction of inputs touched once."""
    if isinstance(mb_input_ids, torch.Tensor):
        mb_input_ids = mb_input_ids.cpu().numpy()
    ids = np.asarray(mb_input_ids).ravel()
    ids = ids[ids != INVALID]
    _, counts = np.unique(ids, return_counts=True)
    return float((counts == 1).sum() / max(1, len(counts)))
