from repro_torch.core.samplers.base import LayerSample, Sampler, make_sampler
from repro_torch.core.samplers.labor import LaborSampler

__all__ = ["LayerSample", "LaborSampler", "Sampler", "make_sampler"]
