"""Launch helpers of the port: the cooperative process group
(:func:`make_coop_group`) and the torchrun training launcher
(``python -m repro_torch.launch.train``)."""
from repro_torch.launch.mesh import make_coop_group, rank_device

__all__ = ["make_coop_group", "rank_device"]
