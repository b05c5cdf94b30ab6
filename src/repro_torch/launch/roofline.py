"""Roofline terms of a traced step on the H100, and the model-FLOP count;
port of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), from the per-device record of
:mod:`repro_torch.launch.op_costs`:

    compute    = dot FLOPs per device        / peak FLOP/s
    memory     = HBM bytes per device        / HBM_BW
    collective = collective bytes per device / LINK_BW

H100 SXM constants, from NVIDIA's H100 data sheet, each for the card at
its 700 W limit (a card set lower runs slower under load):

* ``PEAK_FLOPS_BF16`` 989e12 FLOP/s: bfloat16 dense on the tensor cores,
  the dry-run's dtype (the reference's ``dtype="bfloat16"`` override).
* ``PEAK_FLOPS`` 67e12 FLOP/s: float32 outside the tensor cores.  The
  port's training runs float32 with TF32 off; a float32 step is timed
  against this peak.
* ``HBM_BW`` 3.35e12 B/s: HBM3.
* ``LINK_BW`` 450e9 B/s: NVLink 4, one direction (900 GB/s both ways).

The reference places its cooperation domain on one fast-interconnect
island.  An H100 NVLink domain is one node of 8 GPUs, so a 16-wide mesh
dim spans two nodes and its collectives cross the slower inter-node
network: on such a dim the collective term is a lower bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

# H100 SXM, 700 W (NVIDIA data sheet)
PEAK_FLOPS = 67e12        # float32 FLOP/s outside the tensor cores (TF32 off)
PEAK_FLOPS_BF16 = 989e12  # bfloat16 dense FLOP/s on the tensor cores
HBM_BW = 3.35e12          # B/s HBM3
LINK_BW = 450e9           # B/s NVLink 4, one direction


def peak_flops(dtype) -> float:
    """The compute peak for a step's dtype (``torch.bfloat16`` or float32)."""
    import torch

    return PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, "bfloat16") else PEAK_FLOPS


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def collective_stats(costs) -> CollectiveStats:
    """The counter's collectives by XLA op name (the reference's
    ``parse_collectives`` reads them from HLO text)."""
    return CollectiveStats(
        {k: v["bytes"] for k, v in costs.coll_detail.items()},
        {k: v["count"] for k, v in costs.coll_detail.items()},
    )


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


def analyze(costs, num_devices: int, model_flops_global: float,
            dtype="bfloat16") -> Roofline:
    """Roofline terms from an :class:`~repro_torch.launch.op_costs.OpCosts`
    record (the reference reads the compiled module).  Every term is per
    device; ``useful_ratio`` is the model FLOPs over all devices' dot
    FLOPs."""
    flops = costs.dot_flops
    compute_s = flops / peak_flops(dtype)
    memory_s = costs.hbm_bytes / HBM_BW
    collective_s = costs.coll_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return Roofline(
        flops_per_dev=flops,
        hbm_bytes_per_dev=costs.hbm_bytes,
        coll_bytes_per_dev=costs.coll_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops_global=model_flops_global,
        useful_ratio=model_flops_global / max(flops * num_devices, 1.0),
        coll_detail=costs.coll_detail,
        peak_mem_bytes=float(costs.peak_bytes),
    )


def model_flops(cfg, shape_spec, active_params: int) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode)."""
    B, S = shape_spec.global_batch, shape_spec.seq_len
    if shape_spec.kind == "train":
        return 6.0 * active_params * B * S
    if shape_spec.kind == "prefill":
        return 2.0 * active_params * B * S
    return 2.0 * active_params * B  # decode: one token per sequence
