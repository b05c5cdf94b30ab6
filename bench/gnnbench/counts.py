"""The benchmark's yardstick of work: model FLOPs of a step, and the bytes
and operations that a step's feature gather and neighbor aggregations need.

Counted from the reference's layout of a step's work (``Reference.pe_work``:
each PE's valid destination rows, kept edges and input rows), so the same
work counts the same whatever implements it; padding counts nothing.

* Model FLOPs: the dense transforms (2 FLOPs a multiply-add) and the
  neighbor aggregations (one add an edge and feature, and one for the
  vertex itself in the GCN), forward and backward, with no recompute.
  Backward: the weight gradients of every layer, and the input gradients
  (transform and aggregation) of every layer but the input layer, whose
  features need none.  Biases, ReLUs and the cross-entropy are left out.
* Bytes (H100 data sheet: 3.35 TB/s; operations at 67 TFLOP/s): each input
  read once and each output written once, as ``chip_smoke.py``'s phase 1
  counts them, over valid rows only.  The gather: the valid ids, each
  distinct row read once, each valid output row written once.  The
  aggregation forward: the mask of the valid rows (one byte a slot), an
  index a kept edge, each distinct source row read once, each valid
  output row written once; its backward: the mask, the indices, each
  output-gradient row that has a kept edge read once, each source row's
  gradient written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FLOAT32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores (TF32 off)


def dims(model: dict, l: int) -> tuple[int, int]:
    L = model["num_layers"]
    return (model["in_dim"] if l == L - 1 else model["hidden_dim"],
            model["num_classes"] if l == 0 else model["hidden_dim"])


def _relations(model: dict) -> int:
    return model["num_relations"] if model["kind"] == "rgcn" else 1


def _masks(model: dict, keep, etypes) -> list:
    """The slot masks that one aggregation call each takes: the kept slots
    (GCN), or the kept slots of each relation (R-GCN)."""
    if model["kind"] == "rgcn":
        return [keep & (etypes == r) for r in range(model["num_relations"])]
    return [keep]


def step_flops(model: dict, work: list) -> int:
    """Model FLOPs of one step from ``Reference.pe_work``."""
    L, R = model["num_layers"], _relations(model)
    transforms = 1 + R if model["kind"] == "rgcn" else 1
    total = 0
    for pe in work:
        for l, (dst, _nbr, keep, _et) in enumerate(pe["layers"]):
            d_in, d_out = dims(model, l)
            n, e = dst.numel(), int(keep.sum())
            agg = (e + n) * d_in if model["kind"] == "gcn" else e * d_in
            mm = 2 * n * d_in * d_out * transforms
            total += agg + mm      # forward
            total += mm            # weight gradients
            if l < L - 1:
                total += mm + agg  # input gradients
    return total


def _distinct(ids) -> int:
    import torch

    return int(torch.unique(ids).numel()) if ids.numel() else 0


def gather_cost(model: dict, work: list) -> tuple[int, int]:
    """``(bytes, operations)`` of the step's one feature gather."""
    import torch

    d = model["in_dim"]
    n = sum(pe["inputs"].numel() for pe in work)
    distinct = _distinct(torch.cat([pe["inputs"] for pe in work]))
    return 4 * n + 4 * d * distinct + 4 * d * n, n


def spmm_costs(model: dict, work: list) -> list:
    """``[(bytes, operations)]`` of every aggregation call of a step, forward
    and backward, one a PE, layer and relation."""
    L = model["num_layers"]
    out = []
    for pe in work:
        for l, (dst, nbr, keep, et) in enumerate(pe["layers"]):
            d = dims(model, l)[0]
            n, w = dst.numel(), nbr.shape[1]
            for m in _masks(model, keep, et):
                nnz = int(m.sum())
                touched = _distinct(nbr[m])
                out.append((n * w + 4 * nnz + 4 * d * touched + 4 * n * d, nnz * d))
                if l < L - 1:
                    rows_hit = int(m.any(dim=1).sum())
                    out.append((n * w + 4 * nnz + 4 * d * rows_hit + 4 * d * touched,
                                nnz * d))
    return out


def bound_s(costs) -> float:
    """The least time of calls of ``(bytes, operations)`` on the H100: each
    call bound by the larger of its bytes and its operations."""
    return sum(max(b / HBM_BYTES_PER_S, o / FLOAT32_FLOPS) for b, o in costs)
