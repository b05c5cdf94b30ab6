"""The JAX package's dry-run records, for the port's dry-run tests.

Run as a script in a process of its own (importing ``repro.launch.dryrun``
sets its 512 host placeholder devices before JAX starts)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/dryrun_reference.py '<request json>'

The request is a list of jobs; each prints one record (a JSON line):
``{"combo": [arch, shape, multi_pod, overrides]}`` (``lower_combo``),
``{"gnn": {...}}`` (``lower_gnn_coop_step`` with these keywords),
``{"specs": [arch, multi_pod]}`` (every parameter's, Adam moment's and
decode-state leaf's spec, and the batch specs, on an ``AbstractMesh``).
A combo's or the GNN's record also has ``hlo``: the HLO walk's dot FLOPs
and XLA's raw cost-analysis FLOPs (the record's ``flops_per_dev`` is the
larger).

Two defects of the reference are worked around here, from outside, and
the JAX package is not edited: under JAX 0.9 ``jax.make_mesh`` gives
Explicit axes, which ``shard_hint``'s ``with_sharding_constraint``
refuses, so the production mesh is rebuilt with Auto axes; and
``gnn_dryrun.LocalGraph.neighbor_table`` takes no ``backend`` keyword,
which ``LaborSampler.sample_layer`` passes, so it is wrapped to accept
and ignore it.
"""
from __future__ import annotations

import json
import sys

import repro.launch.dryrun as dr  # noqa: E402  (sets XLA_FLAGS first)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

import repro.launch.gnn_dryrun as gd  # noqa: E402


def _auto_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))


dr.make_production_mesh = _auto_mesh
_analyze = dr.rl.analyze
_HLO: dict = {}


def _analyze_recording(compiled, num_devices, model_flops_global):
    """``roofline.analyze``, also keeping the HLO walk's own dot FLOPs and
    XLA's raw cost-analysis FLOPs (the record's ``flops_per_dev`` is the
    larger of the two)."""
    from repro.launch.hlo_analysis import analyze_hlo

    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    _HLO["dot_flops"] = analyze_hlo(compiled.as_text()).dot_flops
    _HLO["raw_flops"] = float(cost.get("flops", 0.0))
    return _analyze(compiled, num_devices, model_flops_global)


dr.rl.analyze = _analyze_recording
_neighbor_table = gd.LocalGraph.neighbor_table
gd.LocalGraph.neighbor_table = lambda self, seeds, backend=None: _neighbor_table(self, seeds)


def _spec(s) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in s]


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)


def specs(arch: str, multi_pod: bool) -> dict:
    from repro.configs import get_config
    from repro.launch import shardings as sh
    from repro.launch.specs import SHAPES, batch_specs, decode_state_specs, params_specs

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = AbstractMesh(shape, names)
    cfg = get_config(arch)
    ps = params_specs(cfg)
    out = {"params": {}, "opt": {}, "data": {}, "decode": {}}
    flat = jax.tree_util.tree_flatten_with_path(ps)[0]
    p_sh = jax.tree_util.tree_leaves(sh.param_shardings(mesh, ps))
    o_sh = jax.tree_util.tree_leaves(sh.opt_shardings(mesh, ps))
    for (keys, leaf), p, o in zip(flat, p_sh, o_sh):
        out["params"][_path(keys)] = [list(leaf.shape), _spec(p.spec)]
        out["opt"][_path(keys)] = [list(leaf.shape), _spec(o.spec)]
    for name, spec in SHAPES.items():
        for k, v in batch_specs(cfg, spec).items():
            out["data"][f"{name}/{k}"] = [list(v.shape), _spec(sh.data_spec(mesh, v.shape))]
        if spec.kind == "decode":
            st = decode_state_specs(cfg, spec)
            leaves = jax.tree_util.tree_flatten_with_path(st)[0]
            shs = jax.tree_util.tree_leaves(sh.decode_state_shardings(mesh, st))
            for (keys, leaf), s in zip(leaves, shs):
                out["decode"][f"{name}/{_path(keys)}"] = [list(leaf.shape), _spec(s.spec)]
    return out


def main(request: list) -> None:
    for job in request:
        if "combo" in job:
            arch, shape, mp, ov = job["combo"]
            rec = dr.lower_combo(arch, shape, mp, verbose=False, overrides=ov)
        elif "gnn" in job:
            rec = gd.lower_gnn_coop_step(verbose=False, **job["gnn"])
        else:
            rec = specs(*job["specs"])
        if "combo" in job or "gnn" in job:
            rec["hlo"] = dict(_HLO)
        print(json.dumps({"job": job, "record": rec}, default=float), flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
