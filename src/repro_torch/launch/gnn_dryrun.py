"""Dry-run of the paper's cooperative GNN training step on the mesh; port of
``repro.launch.gnn_dryrun``.

This is the production embodiment of Algorithm 1: every mesh device is a
PE; the graph is 1-D block-partitioned (each PE holds the in-CSR of its
vertex range plus its feature/label rows: owner-partitioned storage);
cooperative sampling, feature loading and forward/backward run on each
PE with ``all_to_all`` over the PE group (the port's
:class:`~repro_torch.core.cooperative.ShardExecutor`).  Multi-pod adds an
outer ``pod`` dim that data-parallelizes independent global batches:
cooperation stays inside one fast-interconnect island, per the paper's
own limitation analysis (§A.11).

:func:`trace_gnn_coop_step` runs rank 0's per-PE program once on fake
tensors at papers100M (or mag240M) shapes over a fake process group of
256 (512) ranks, under :class:`~repro_torch.launch.op_costs.CostCounter`:
no allocation, no arithmetic.  The plan is built with the ``"fused"``
backend: the ``"reference"`` backend deduplicates with ``torch.unique``,
whose output a fake tensor cannot size.  On fake CUDA tensors the
``frontier_gather`` and ``unique_compact`` launches are recorded by the
counter; on fake CPU tensors the plain versions run (static shapes).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.cooperative import (
    CoopCapacityPlan,
    ShardExecutor,
    build_cooperative_minibatch,
    redistribute,
)
from repro_torch.core.graph import INVALID
from repro_torch.core.rng import DependentRNG
from repro_torch.core.samplers import LaborSampler
from repro_torch.train.optim import adam_init, adam_update


# --------------------------------------------------------------------------
# block-local graph + partition (owner-partitioned storage)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LocalGraph:
    """Per-PE CSR block: rows are the PE's owned vertices.

    ``indices`` store GLOBAL source ids; ``v_start`` (a 0-d int32 tensor)
    is the first owned vertex id, so local row = global id - v_start.
    ``edge_types`` (R-GCN, mag240M) aligns with ``indices``.
    """

    indptr: torch.Tensor    # (Vp + 1,)
    indices: torch.Tensor   # (Ep,)
    v_start: torch.Tensor   # () int32
    max_degree: int
    edge_types: Optional[torch.Tensor] = None  # (Ep,) relation ids

    def _local_rows(self, seeds: torch.Tensor) -> torch.Tensor:
        Vp = self.indptr.shape[0] - 1
        local = torch.where(seeds == INVALID, 0, seeds - self.v_start)
        return torch.clamp(local, 0, Vp - 1)

    def _row_window(self, seeds: torch.Tensor):
        Ep = self.indices.shape[0]
        local = self._local_rows(seeds).long()
        offs = self.indptr[local]
        deg = self.indptr[local + 1] - offs
        pos = torch.arange(self.max_degree, dtype=torch.int32, device=seeds.device)[None, :]
        idx = torch.clamp(offs[:, None] + pos, 0, max(Ep - 1, 0))
        mask = (pos < deg[:, None]) & (seeds != INVALID)[:, None]
        return idx, mask

    def neighbor_table(self, seeds: torch.Tensor, backend: str = "reference"):
        """``(nbr (n, max_degree), mask)`` of the seeds' in-neighborhoods,
        INVALID where padded.  ``"fused"`` reads them with the
        ``frontier_gather`` kernel over the block's rows (its plain version
        on the CPU); both are bit-identical to the reference's."""
        if backend == "fused":
            from repro_torch.kernels import frontier_gather

            rows = torch.where(seeds == INVALID, INVALID, self._local_rows(seeds))
            return frontier_gather(self.indptr, self.indices, rows.to(torch.int32).contiguous(),
                                   self.max_degree)
        idx, mask = self._row_window(seeds)
        nbr = self.indices[idx.long()]
        return torch.where(mask, nbr, INVALID), mask

    def neighbor_edge_types(self, seeds: torch.Tensor) -> torch.Tensor:
        idx, mask = self._row_window(seeds)
        return torch.where(mask, self.edge_types[idx.long()], 0)


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """Functional owner map for contiguous blocks (no (V,) array)."""

    verts_per_pe: int
    num_parts: int

    def owner_of(self, ids: torch.Tensor) -> torch.Tensor:
        own = torch.div(ids, self.verts_per_pe, rounding_mode="floor").to(torch.int32)
        own = torch.clamp(own, 0, self.num_parts - 1)
        return torch.where(ids == INVALID, self.num_parts - 1, own)


# --------------------------------------------------------------------------
# problem scales (Table 2) and models (A.5): papers100M/GCN, mag240M/R-GCN
# --------------------------------------------------------------------------
SCALE = dict(
    log2_v=27,          # 134M vertices (papers100M: 111M)
    avg_degree=29,      # papers100M: 29.1
    max_degree=32,      # degree-capped neighbor tables
    feat_dim=128,       # papers100M feature dim
    hidden=1024,        # paper A.5
    classes=172,
    fanout=10,
    layers=3,
    local_batch=1024,   # b per PE; global batch = 1024 * P
    model="gcn",
    num_relations=1,
)

# mag240M / R-GCN (paper §4.3): heavier model M, the regime where the
# paper reports cooperation pays off even at P=2 (α/c > γ/M, Table 1).
SCALE_MAG = dict(
    log2_v=28,          # 268M vertices (mag240M: 244M)
    avg_degree=14,      # mag240M: 14.2
    max_degree=32,
    feat_dim=768,       # mag240M feature dim (fp16-stored in the paper)
    hidden=1024,
    classes=153,
    fanout=10,
    layers=3,
    local_batch=1024,
    model="rgcn",
    num_relations=4,    # author/paper/institution/field edge types
)


def _caps(P: int, bucket_safety: float = 3.0, scale: Optional[dict] = None) -> CoopCapacityPlan:
    """Concavity-informed per-PE frontier capacities.

    Sized from the paper's measured cooperative per-PE frontier sizes on
    papers100M with LABOR-0, b=1024, k=10 (Table 7: |S^1|=9.3k,
    |S^2|=62k, |S^3|=318k, |S~^2|=83k, |S~^3|=463k) with ~30% headroom;
    the concave growth (Thm 3.2) is exactly why these are far below the
    geometric bound b·(k+1)^l.
    """
    scale = scale or SCALE
    assert scale["local_batch"] == 1024 and scale["fanout"] == 10
    caps = (1024, 12288, 81920, 417792)
    tilde = (16384, 106496, 606208)
    buckets = tuple(max(64, int(t // P * bucket_safety) // 8 * 8 + 8) for t in tilde)
    return CoopCapacityPlan(caps, tilde, buckets)


def _gnn_params_specs(scale: dict, dtype=torch.float32, device="meta") -> list:
    """Per-layer parameter dicts (uninitialized ``torch.empty``; meta
    tensors by default).  Plan layer ``l`` computes ``H^l`` from
    ``H^{l+1}``: layer L-1 consumes raw features, layer 0 emits class
    logits (the models/gnn convention)."""
    L = scale["layers"]
    out = []
    for l in range(L):
        d_in = scale["feat_dim"] if l == L - 1 else scale["hidden"]
        d_out = scale["classes"] if l == 0 else scale["hidden"]
        lp = {"w": torch.empty((d_in, d_out), dtype=dtype, device=device),
              "b": torch.empty((d_out,), dtype=dtype, device=device)}
        if scale["model"] == "rgcn":
            lp["w_rel"] = torch.empty((scale["num_relations"], d_in, d_out), dtype=dtype,
                                      device=device)
        out.append(lp)
    return out


def _gcn_layer(p, Ht, self_idx, nbr_idx, mask, etypes, last: bool):
    h_self = Ht[torch.clamp(self_idx, min=0).long()]
    h_nbr = Ht[torch.clamp(nbr_idx, min=0).long()]
    valid = (nbr_idx >= 0) & mask
    h_nbr = torch.where(valid[..., None], h_nbr, 0.0)
    deg = torch.sum(valid, dim=-1, keepdim=True) + 1
    agg = (torch.sum(h_nbr, dim=-2) + h_self) / deg
    out = agg @ p["w"] + p["b"]
    return out if last else torch.relu(out)


def _rgcn_layer(p, Ht, self_idx, nbr_idx, mask, etypes, last: bool):
    """R-GCN (Schlichtkrull et al.): per-relation mean aggregation."""
    h_self = Ht[torch.clamp(self_idx, min=0).long()]
    h_nbr = Ht[torch.clamp(nbr_idx, min=0).long()]
    valid = (nbr_idx >= 0) & mask
    out = h_self @ p["w"] + p["b"]
    R = p["w_rel"].shape[0]
    et = etypes if etypes is not None else torch.zeros(mask.shape, dtype=torch.int32,
                                                       device=mask.device)
    for r in range(R):
        m_r = valid & (et == r)
        s = torch.sum(torch.where(m_r[..., None], h_nbr, 0.0), dim=-2)
        n = torch.clamp(torch.sum(m_r, dim=-1, keepdim=True), min=1)
        out = out + (s / n) @ p["w_rel"][r]
    return out if last else torch.relu(out)


#: the plan backend of the dry-run's step: ``"reference"`` deduplicates with
#: ``torch.unique``, whose output a fake tensor cannot size
PLAN_BACKEND = "fused"


def make_coop_train_step(P: int, group, caps: CoopCapacityPlan, grad_group=None,
                         scale: Optional[dict] = None, on_grads=None):
    """Cooperative GNN train step body (runs on each PE, as the reference's
    does inside ``shard_map``): ``step(params, opt, indptr, indices,
    v_start, feats, labels, seeds, rng_step, etypes=None) -> (params, opt,
    loss)``.

    ``group`` is the PE process group (the all-to-alls, and the loss's
    mean, one all-reduce of the 0-d local loss); ``grad_group`` (default
    ``group``; with pods, ``pe`` and ``pod``) is where the gradients are
    averaged, one all-reduce of all of them flattened into one buffer:
    the reference's two ``pmean``s.  The parameters
    (a list of dicts of tensors) and the moments are updated in place.
    The plan is built with ``PLAN_BACKEND``.  ``on_grads``, if given, is called with the averaged gradients (one a
    parameter, in the order of ``params``' values) before the update.
    """
    scale = scale or SCALE
    sampler = LaborSampler(fanout=scale["fanout"], backend=PLAN_BACKEND)
    part = BlockPartition((1 << scale["log2_v"]) // P, P)
    ex = ShardExecutor(P, group=group)
    L = scale["layers"]
    grad_group = grad_group if grad_group is not None else group
    layer_fn = _rgcn_layer if scale["model"] == "rgcn" else _gcn_layer

    def step(params, opt, indptr, indices, v_start, feats, labels, seeds,
             rng_step, etypes=None):
        graph = LocalGraph(indptr, indices, v_start, scale["max_degree"], edge_types=etypes)
        rng = DependentRNG(base_seed=0, kappa=64).state_at(rng_step)
        mb = build_cooperative_minibatch(graph, sampler, part, seeds, rng, L, caps, ex,
                                         backend=PLAN_BACKEND)
        flat = [p for lp in params for p in lp.values()]
        with torch.enable_grad():
            ids = mb.input_ids
            local = torch.clamp(torch.where(ids == INVALID, 0, ids - v_start),
                                0, feats.shape[0] - 1).long()
            H = torch.where((ids != INVALID)[:, None], feats[local], 0.0)
            for l in reversed(range(L)):
                blk = mb.layers[l]
                Ht = redistribute(ex, blk, H, caps.tilde_caps[l])
                H = layer_fn(params[l], Ht, blk.self_idx, blk.nbr_idx, blk.mask,
                             blk.etypes, last=(l == 0))
            seed_ids = mb.seed_ids
            lab_local = torch.clamp(torch.where(seed_ids == INVALID, 0, seed_ids - v_start),
                                    0, labels.shape[0] - 1).long()
            y = labels[lab_local]
            valid = seed_ids != INVALID
            logits = H.float()
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, y[:, None].long())[:, 0]
            n = torch.clamp(torch.sum(valid), min=1)
            loss = torch.sum(torch.where(valid, logz - ll, 0.0)) / n
            grads = torch.autograd.grad(loss, flat)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
        buf = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(buf, group=grad_group)
        size = dist.get_world_size(grad_group)
        grads = [b.reshape(p.shape) / size
                 for b, p in zip(torch.split(buf, [p.numel() for p in flat]), flat)]
        if on_grads is not None:
            on_grads(grads)
        opt = adam_update(flat, grads, opt, lr=1e-3)
        return params, opt, loss

    return step


def trace_gnn_coop_step(
    multi_pod: bool = False,
    verbose: bool = True,
    feat_dtype: str = "float32",
    bucket_safety: float = 3.0,
    model: str = "gcn",
    tag: str = "",
    device: str = "cuda",
    num_pes: int = 256,
    scale: Optional[dict] = None,
    num_edges: Optional[int] = None,
) -> dict:
    """Trace rank 0's per-PE train step at the reference's shapes
    (``NPE = 256`` PEs, papers100M ``SCALE`` or, with ``model="rgcn"``,
    mag240M ``SCALE_MAG``) on fake ``device`` tensors and return its
    record (the reference's keys, ``trace_s`` for ``lower_s`` and
    ``compile_s``).  ``num_pes``, ``scale`` and ``num_edges`` (the block's
    edges, else ``avg_degree`` a vertex) trace another configuration, e.g.
    a measured run's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import fake_process_group
    from repro_torch.launch.op_costs import CostCounter

    scale = scale or (SCALE_MAG if model == "rgcn" else SCALE)
    NPE = num_pes
    pods = 2 if multi_pod else 1
    V = 1 << scale["log2_v"]
    vp = V // NPE
    ep = num_edges or vp * scale["avg_degree"]
    caps = _caps(NPE, bucket_safety=bucket_safety, scale=scale)
    fdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[feat_dtype]
    rgcn = scale["model"] == "rgcn"
    dev = torch.device(device)
    with fake_process_group(pods * NPE):
        mesh = init_device_mesh(dev.type, (pods, NPE), mesh_dim_names=("pod", "pe"))
        pe_group = mesh.get_group("pe")
        grad_group = dist.group.WORLD if multi_pod else pe_group
        step = make_coop_train_step(NPE, pe_group, caps, grad_group=grad_group, scale=scale)
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = [{k: v.requires_grad_() for k, v in lp.items()}
                      for lp in _gnn_params_specs(scale, device=dev)]
            opt = adam_init([p for lp in params for p in lp.values()])

            def empty(shape, dtype=torch.int32):
                return torch.empty(shape, dtype=dtype, device=dev)

            args = dict(
                indptr=empty((vp + 1,)), indices=empty((ep,)), v_start=empty(()),
                feats=empty((vp, scale["feat_dim"]), fdt), labels=empty((vp,)),
                seeds=empty((scale["local_batch"],)),
                etypes=empty((ep,)) if rgcn else None,
            )
            cc = CostCounter()
            t0 = time.perf_counter()
            with cc:
                cc.add_arguments(params, opt, [a for a in args.values() if a is not None])
                step(params, opt, args["indptr"], args["indices"], args["v_start"],
                     args["feats"], args["labels"], args["seeds"], 0, args["etypes"])
            t_trace = time.perf_counter() - t0
    model_flops = 0.0  # GNN: flops are data-dependent; report the counted terms only
    roof = rl.analyze(cc.costs, pods * NPE, model_flops, dtype=torch.float32)
    result = {
        "arch": "gnn-coop-mag240M-rgcn" if rgcn else "gnn-coop-papers100M-gcn",
        "shape": f"b{scale['local_batch']}xP{NPE}",
        "mesh": f"pod{pods}x{NPE}",
        "tag": tag,
        "overrides": {"feat_dtype": feat_dtype, "bucket_safety": bucket_safety,
                      "model": scale["model"], "backend": PLAN_BACKEND, "device": dev.type},
        "status": "ok",
        "devices": pods * NPE,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": cc.costs.argument_bytes,
            "peak_per_device_gb": roof.peak_mem_bytes / 2**30,
        },
        "roofline": roof.to_dict(),
        "hbm_bytes": cc.costs.hbm_bytes,
        "kernel_launches": cc.costs.kernel_launches,
    }
    if verbose:
        print(
            f"[{result['arch']} | {result['shape']} | {result['mesh']}] ok "
            f"trace {t_trace:.1f}s "
            f"peak/dev {result['memory']['peak_per_device_gb']:.2f} GiB "
            f"bottleneck={roof.bottleneck} "
            f"(c={roof.compute_s*1e3:.2f}ms m={roof.memory_s*1e3:.2f}ms "
            f"coll={roof.collective_s*1e3:.2f}ms) kernels {cc.costs.kernel_launches}",
            flush=True,
        )
    return result
