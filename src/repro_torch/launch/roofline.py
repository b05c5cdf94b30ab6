"""Roofline constants of the H100 and the model-FLOP count; part of the
port of ``repro.launch.roofline``.

The port runs float32 with TF32 off, so its products run outside the
tensor cores: the compute peak is the H100 SXM's float32 rate there
(NVIDIA data sheet), the memory rate its HBM3's.  A share of the peak
is stated with the card's power limit beside it (the peaks assume
700 W).

``analyze`` and ``parse_collectives`` read a compiled XLA program's HLO
text (``cost_analysis``, ``memory_analysis``, the collective ops); they
come with the dry-run slice (``dryrun.py``, ``hlo_analysis.py``), with
the link rate their collective term needs.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

# H100 SXM
PEAK_FLOPS = 67e12       # float32 FLOP/s outside the tensor cores (TF32 off)
HBM_BW = 3.35e12         # B/s HBM3


@dataclass
class Roofline:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    useful_ratio: float
    coll_detail: dict
    peak_mem_bytes: float

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def model_flops(cfg, shape_spec, active_params: int) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode)."""
    B, S = shape_spec.global_batch, shape_spec.seq_len
    if shape_spec.kind == "train":
        return 6.0 * active_params * B * S
    if shape_spec.kind == "prefill":
        return 2.0 * active_params * B * S
    return 2.0 * active_params * B  # decode: one token per sequence
