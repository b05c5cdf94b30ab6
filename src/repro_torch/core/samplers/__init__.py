from repro_torch.core.samplers.base import LayerSample, Sampler, make_sampler
from repro_torch.core.samplers.full import FullSampler
from repro_torch.core.samplers.labor import LaborSampler
from repro_torch.core.samplers.neighbor import NeighborSampler
from repro_torch.core.samplers.random_walk import RandomWalkSampler

__all__ = [
    "FullSampler", "LaborSampler", "LayerSample", "NeighborSampler",
    "RandomWalkSampler", "Sampler", "make_sampler",
]
