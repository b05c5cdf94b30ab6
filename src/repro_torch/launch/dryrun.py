"""Multi-pod dry-run: trace every (arch x shape x mesh) combo on fake tensors;
port of ``repro.launch.dryrun``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --gnn   # the paper's own pipeline
    ... [--device cpu]  # fake CPU tensors (the default is fake CUDA tensors)

The reference lowers and compiles each step with XLA over 512 host
placeholder devices.  Here each combo runs its step once, eagerly, as
rank 0 of a fake process group of 256 (512) ranks
(:func:`~repro_torch.launch.mesh.fake_process_group`) on the production
``DeviceMesh`` (16x16, or 2x16x16 with pods): parameters, Adam moments,
batch and decode state are DTensors placed by
:mod:`repro_torch.launch.shardings`, over local tensors of
``FakeTensorMode`` (shapes, no storage, no arithmetic).  DTensor's
sharding propagation inserts the collectives GSPMD would, and
:class:`~repro_torch.launch.op_costs.CostCounter` charges rank 0's local
ops.  Nothing compiles, so a record has ``trace_s`` where the reference's
has ``lower_s`` and ``compile_s``; its other keys are the reference's.

Each combo writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(the reference writes ``experiments/dryrun/``) with the memory record,
the counter's costs and the roofline terms (:func:`roofline.analyze`,
H100 constants).  A combo that fails is recorded with ``"status":
"error"`` and the CLI exits 1.

Where DTensor has no sharding strategy for an op of the port's model,
or its strategy would replicate a sharded operand where GSPMD keeps it
sharded, the model code (under the mesh that ``set_logical_mesh``
registers; the identity without one) writes the collective out:

* the embedding read (``model._embed_tokens``): a vocabulary-sharded
  table read with ``F.embedding`` (masked rows, summed over the model dim
  at once);
* attention whose heads do not divide the model dim (gemma2-2b's 8,
  whisper-tiny's 6): queries move to a split by position over the model
  dim (one all-to-all) and keys and values are all-gathered over it
  (``attention._mesh_layout``); the output moves back to column shards
  (``_merge_heads``); banded windows, which cross the position shards,
  gather the queries and run whole on each model rank
  (``_whole_sequence``);
* attention whose heads divide it runs each device's heads in
  ``local_map`` (``attention._per_head``): DTensor's batched product
  cannot take batch and heads flattened into one dim split over two mesh
  dims;
* decode (``attention._decode_per_shard``): the cache write and the
  attention on each device's shard in ``local_map``; a cache split over
  head_dim all-reduces the partial scores; a cache split by position
  over the data dim (``long_500k``) writes the new key only on the shard
  that holds its slot (no strategy exists for an ``index_copy_`` into a
  split dim) and reduces the softmax's max and sum and the output over
  the shards;
* the flash loop's running max, sum and accumulator start as tensors
  placed like the queries (``*_like``), not as full-size local tensors;
* the chunked cross-entropy (``steps._ce_sum``): logits split over the
  vocabulary take the vocab-parallel form (max, exp-sum and the label's
  logit all-reduced over the model dim); ``logsumexp`` would all-gather
  the logits and ``gather``'s backward allocates a replicated gradient;
* row-parallel products and each mixer's residual are reduced at once
  (``modules._reduced``, the hints in ``_block``), and ``shard_hint``
  constrains the gradient as JAX's sharding constraint does: a partial
  gradient left alone makes DTensor all-gather weights in the backward;
* the MoE groups (``moe._moe_groups``): each device routes its own
  groups in ``local_map``, the expert weights all-gathered over the batch
  dims (expert-parallel or FSDP shards), their ff split kept;
* the SSD (``ssm.ssm_train``): the fused in-projection and the conv's
  output gathered over the model dim, the chunked scan (its ``cumsum``
  included) on each device's heads in ``local_map`` (``_per_ssm_head``);
* the loss is redistributed to replicated at the end of the step, so the
  deferred ``Partial`` reductions are paid inside the step, as the
  reference's ``out_shardings`` make XLA pay them.

``torch.utils.checkpoint`` (remat, the CE chunks) and ``adam_update``'s
in-place updates run under DTensor as they are (an in-place ``copy_``
into a moment or parameter redistributes its operand to the target's
placements).  The serving forwards run under ``torch.no_grad()`` in
place of ``torch.inference_mode()``, which DTensor does not support.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.op_costs import CostCounter, _cluster_all_to_all, _shadow_ops_uncounted
from repro_torch.launch.shardings import (
    data_spec,
    decode_state_shardings,
    local_shape,
    opt_shardings,
    param_shardings,
    replicated,
    to_placements,
)
from repro_torch.launch.specs import (
    SHAPES,
    ShapeSpec,
    batch_specs,
    decode_state_specs,
    params_specs,
    shape_applicable,
)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer.config import active_param_count
from repro_torch.train.optim import AdamState

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

def _mesh_tag(multi_pod: bool, mesh_shape: Optional[tuple] = None) -> str:
    if mesh_shape is not None:
        return "x".join(map(str, mesh_shape))
    return "pod2x16x16" if multi_pod else "pod16x16"


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v.lower() in ("true", "false"):
        return k, v.lower() == "true"
    try:
        return k, int(v)
    except ValueError:
        try:
            return k, float(v)
        except ValueError:
            return k, v


def _contiguous_stride(shape: tuple) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def sharded(mesh, shape: tuple, dtype: torch.dtype, placements, device) -> torch.Tensor:
    """A DTensor of global ``shape`` over ``mesh`` whose local tensor is an
    uninitialized ``torch.empty`` (a fake tensor under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(mesh, shape, placements), dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _shard_model(model, mesh, p_sh: dict, device) -> None:
    """Replace every (meta) parameter of ``model`` by a DTensor parameter."""
    for name, p in list(model.named_parameters()):
        prefix, _, leaf = name.rpartition(".")
        parent = model.get_submodule(prefix) if prefix else model
        dt = sharded(mesh, tuple(p.shape), p.dtype, p_sh[name], device)
        parent.register_parameter(leaf, nn.Parameter(dt, requires_grad=p.requires_grad))


def _shard_tree(tree, placements, mesh, device):
    if isinstance(tree, dict):
        return {k: _shard_tree(v, placements[k], mesh, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shard_tree(v, p, mesh, device) for v, p in zip(tree, placements)]
    if isinstance(tree, torch.Tensor):
        return sharded(mesh, tuple(tree.shape), tree.dtype, placements, device)
    return tree


#: how many groups of the peak's live tensors a record lists (``--peak-split``)
SPLIT_PEAK = [0]


def run_traced(args: tuple, fn, finish=None):
    """Run ``fn(*args)`` under a fresh :class:`CostCounter` with DTensor's
    implicit replication on (plain tensors meet DTensors as replicated
    ones), registering ``args`` as the step's arguments; ``finish`` maps
    the outputs to what the step returns (its redistributions counted).
    Returns ``(counter, outputs, seconds)``."""
    from torch.distributed.tensor.experimental import implicit_replication

    cc = CostCounter(split_peak=SPLIT_PEAK[0] > 0)
    t0 = time.perf_counter()
    with cc, _shadow_ops_uncounted(cc), _cluster_all_to_all(), implicit_replication():
        cc.add_arguments(*args)
        out = fn(*args)
        if finish is not None:
            out = finish(out)
    secs = time.perf_counter() - t0
    cc.outputs = cc.output_bytes(out)
    return cc, out, secs


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _clear_device_caches() -> None:
    """Host caches keyed by device that a trace may fill with fake tensors."""
    from repro_torch.models.transformer.modules import _inv_freqs

    _inv_freqs.cache_clear()


def trace_combo(
    arch: str,
    shape: Union[str, ShapeSpec],
    multi_pod: bool,
    verbose: bool = True,
    overrides: Optional[dict] = None,
    tag: str = "",
    device: str = "cuda",
    mesh_shape: Optional[tuple] = None,
) -> dict:
    """Trace one (arch x shape x mesh) step as rank 0 and return its record.

    ``shape`` names an entry of ``SHAPES`` or is a :class:`ShapeSpec` of
    its own.  ``overrides`` replace config fields (the reference's
    ``dtype="bfloat16"`` and ``moe_groups`` = the batch shards are the
    defaults) and may set ``moe_fsdp``.  ``device`` is the fake tensors'
    device (``"cuda"`` or ``"cpu"``); ``mesh_shape`` a ``(data, model)``
    mesh in place of the production one (e.g. ``(1, 1)``: one device).
    Starts and tears down its own fake process group.
    """
    from repro_torch.models.transformer.modules import set_logical_mesh

    spec = SHAPES[shape] if isinstance(shape, str) else shape
    n_batch_shards = 32 if multi_pod else 16
    if mesh_shape is not None:
        n_batch_shards = mesh_shape[0]
    overrides = dict(overrides or {})
    moe_fsdp = overrides.pop("moe_fsdp", False)
    cfg = dataclasses.replace(
        get_config(arch), **{"dtype": "bfloat16", "moe_groups": n_batch_shards, **overrides})
    mesh_tag = _mesh_tag(multi_pod, mesh_shape)
    ok, why = shape_applicable(cfg, spec.name)
    if not ok:
        return {"arch": arch, "shape": spec.name, "mesh": mesh_tag,
                "status": "skipped", "reason": why}
    world = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod else 256)
    dev = torch.device(device)
    with fake_process_group(world):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
        else:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh(dev.type, tuple(mesh_shape),
                                    mesh_dim_names=("data", "model"))
        set_logical_mesh(mesh)
        try:
            cc, t_trace = _trace_step(cfg, spec, mesh, moe_fsdp, dev)
        finally:
            set_logical_mesh(None)
            _clear_device_caches()
        n_dev = mesh.size()
    costs = cc.costs
    mf = rl.model_flops(cfg, spec, active_param_count(get_config(arch)))
    roof = rl.analyze(costs, n_dev, mf, dtype=cfg.dtype)
    result = {
        "arch": arch,
        "shape": spec.name,
        "mesh": mesh_tag,
        "tag": tag,
        "overrides": {**overrides, **({"moe_fsdp": True} if moe_fsdp else {}),
                      "device": dev.type},
        "status": "ok",
        "devices": n_dev,
        "trace_s": round(t_trace, 1),
        "memory": _memory(cc),
        "roofline": roof.to_dict(),
        "hbm_bytes": costs.hbm_bytes,
        "kernel_launches": costs.kernel_launches,
    }
    if verbose:
        _print(result, roof)
    return result


def _memory(cc) -> dict:
    """The reference's memory keys, per device: arguments, outputs, the
    outputs' part updated in place in an argument (``alias``), and
    ``temp`` = peak - arguments - outputs + alias (the reference's peak is
    temp + arguments + outputs - alias)."""
    out, alias = cc.outputs
    peak = cc.costs.peak_bytes
    mem = {
        "argument_bytes": cc.costs.argument_bytes,
        "output_bytes": out,
        "temp_bytes": peak - cc.costs.argument_bytes - out + alias,
        "alias_bytes": alias,
        "peak_per_device_gb": peak / 2**30,
    }
    if cc.split_peak:
        mem["peak_split"] = [dict(zip(("bytes", "count", "op", "shape", "dtype"), row))
                             for row in cc.peak_split(SPLIT_PEAK[0])]
    return mem


def _print(result: dict, roof) -> None:
    print(
        f"[{result['arch']} | {result['shape']} | {result['mesh']}] ok "
        f"trace {result['trace_s']:.1f}s "
        f"peak/dev {result['memory']['peak_per_device_gb']:.2f} GiB "
        f"bottleneck={roof.bottleneck} "
        f"(c={roof.compute_s*1e3:.2f}ms m={roof.memory_s*1e3:.2f}ms "
        f"coll={roof.collective_s*1e3:.2f}ms) useful={roof.useful_ratio:.2f}",
        flush=True,
    )
    for g in result["memory"].get("peak_split", []):
        print(f"  live at the peak: {g['bytes'] / 2**30:8.3f} GiB in {g['count']:4d} x "
              f"{g['shape']} {g['dtype']} from {g['op']}", flush=True)


def _trace_step(cfg, spec: ShapeSpec, mesh, moe_fsdp: bool, dev) -> tuple:
    """Build the combo's DTensor arguments and run its step under a
    counter: ``(counter, seconds)``.  The specs are meta tensors; the
    step's arguments are made, and the step runs, in a ``FakeTensorMode``."""
    model = params_specs(cfg)
    p_sh = param_shardings(mesh, model, moe_fsdp)
    with _fake_mode():
        return _trace_in_fake_mode(cfg, spec, mesh, model, p_sh, dev)


def _trace_in_fake_mode(cfg, spec: ShapeSpec, mesh, model, p_sh: dict, dev) -> tuple:
    _shard_model(model, mesh, p_sh, dev)

    def data(meta: dict) -> dict:
        return {k: sharded(mesh, tuple(v.shape), v.dtype,
                           to_placements(mesh, data_spec(mesh, tuple(v.shape))), dev)
                for k, v in meta.items()}

    rep = replicated(mesh)
    if spec.kind == "train":
        o_sh = opt_shardings(mesh, model)
        names = [n for n, _ in model.named_parameters()]

        def moment():
            return [sharded(mesh, tuple(p.shape),
                            torch.float32 if p.dtype.is_floating_point else p.dtype,
                            o_sh[n], dev) for n, p in zip(names, model.parameters())]

        opt = AdamState(step=sharded(mesh, (), torch.int32, rep, dev), mu=moment(),
                        nu=moment())
        batch = data(batch_specs(cfg, spec))
        step = make_train_step(cfg)
        cc, _, secs = run_traced(
            (model, opt, batch), step,
            finish=lambda out: (out[0], out[1], out[2]["loss"].redistribute(mesh, rep)))
    elif spec.kind == "prefill":
        batch = data(batch_specs(cfg, spec))
        step = _serving_step(cfg, "prefill")
        cc, _, secs = run_traced((model, batch), step)
    else:  # decode
        state_m = decode_state_specs(cfg, spec)
        state = _shard_tree(state_m, decode_state_shardings(mesh, state_m), mesh, dev)
        token = data(batch_specs(cfg, spec))["token"]
        step = _serving_step(cfg, "decode")
        cc, _, secs = run_traced((model, state, token), step)
    return cc, secs


def _serving_step(cfg, kind: str):
    """``make_prefill_step`` / ``make_serve_step``'s function with the
    forward run under ``torch.no_grad()`` in place of its
    ``torch.inference_mode()``, which DTensor cannot run under (an
    inference tensor has no version counter for its views); the ops are
    the same."""
    from repro_torch.models.transformer.model import forward_decode, forward_prefill

    if kind == "prefill":
        fwd = forward_prefill.__wrapped__

        @torch.no_grad()
        def prefill_step(model, batch):
            return fwd(model, cfg, batch["tokens"], batch.get("prefix_embeds"),
                       batch.get("enc_out"))[0]

        return prefill_step
    fwd = forward_decode.__wrapped__

    @torch.no_grad()
    def serve_step(model, state, token):
        return fwd(model, cfg, state, token)

    return serve_step


def run_gnn_dryrun(multi_pod: bool = False, verbose: bool = True,
                   overrides: Optional[dict] = None, tag: str = "",
                   device: str = "cuda") -> dict:
    """Trace the paper's own cooperative GNN train step on the mesh.

    PEs = all mesh devices (the paper's cooperation domain); the graph is
    block-partitioned so each PE's feature shard is a contiguous row
    block (production feature stores are owner-partitioned the same way).
    """
    from repro_torch.launch.gnn_dryrun import trace_gnn_coop_step

    return trace_gnn_coop_step(multi_pod=multi_pod, verbose=verbose, tag=tag,
                               device=device, **(overrides or {}))


def _record_name(r: dict, tag: str) -> str:
    name = f"{r.get('arch', 'gnn')}__{r.get('shape', 'coop')}__{r['mesh']}"
    return name + (f"__{tag}" if tag else "")


def main(argv: Optional[list] = None, out_dir: Optional[Path] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--gnn", action="store_true")
    ap.add_argument("--multi-pod", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (hillclimb experiments)")
    ap.add_argument("--tag", default="", help="suffix for the result json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors (no card is used either way)")
    ap.add_argument("--peak-split", type=int, default=0, metavar="N",
                    help="print and record the N largest groups of tensors live at the "
                         "peak (by the op that made them, shape and dtype)")
    args = ap.parse_args(argv)
    SPLIT_PEAK[0] = args.peak_split
    overrides = dict(_parse_override(kv) for kv in args.overrides)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    out_dir = Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    if args.gnn:
        for mp in meshes:
            try:
                results.append(run_gnn_dryrun(multi_pod=mp, overrides=overrides,
                                              tag=args.tag, device=args.device))
            except Exception as e:  # a failure here is a bug: record it
                traceback.print_exc()
                results.append({"arch": "gnn", "shape": "coop",
                                "mesh": "pod2x256" if mp else "pod1x256",
                                "status": "error", "error": repr(e)})
    else:
        archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
        shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    try:
                        results.append(trace_combo(arch, shape, mp, overrides=overrides,
                                                   tag=args.tag, device=args.device))
                    except Exception as e:  # a failure here is a bug: record it
                        traceback.print_exc()
                        results.append({"arch": arch, "shape": shape,
                                        "mesh": _mesh_tag(mp), "status": "error",
                                        "error": repr(e)})
    for r in results:
        with open(out_dir / (_record_name(r, args.tag) + ".json"), "w") as f:
            json.dump(r, f, indent=2)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
