"""The port's sharding rules (``repro_torch.launch.shardings``) against the
JAX package's (``repro.launch.shardings``), held exactly.

For all ten architectures at their published sizes, on the single-pod
(16, 16) and two-pod (2, 16, 16) meshes: every parameter's spec, every
Adam moment's (the reference's stacked layout), every batch spec and every
decode-state leaf's equal the reference's ``PartitionSpec``s, which come
from one subprocess (``tests/dryrun_reference.py``, on ``AbstractMesh``es).
The port's per-layer placements drop the unit axis; where the
reference's ZeRO-1 shards a moment's unit axis, the layer's moment
shards its own first free dim instead, with the same bytes a device.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch.shardings import (
    MeshShape,
    data_spec,
    decode_state_shardings,
    decode_state_spec,
    local_shape,
    opt_shardings,
    opt_spec,
    param_shardings,
    param_spec,
    reference_layout,
    to_placements,
)
from repro_torch.launch.specs import SHAPES, batch_specs, decode_state_specs, params_specs

ROOT = Path(__file__).resolve().parents[1]
MESHES = {False: MeshShape(("data", "model"), (16, 16)),
          True: MeshShape(("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(scope="module")
def ref_specs() -> dict:
    jobs = [{"specs": [arch, mp]} for arch in ALL_ARCHS for mp in (False, True)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "dryrun_reference.py"),
                          json.dumps(jobs)], capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    recs = {}
    for line in out.stdout.splitlines():
        d = json.loads(line)
        recs[tuple(d["job"]["specs"])] = d["record"]
    return recs


def _norm(spec) -> tuple:
    """A spec with one-name tuples as the name itself, lists as tuples."""
    out = []
    for a in spec:
        if isinstance(a, (list, tuple)):
            a = tuple(a)
            a = a[0] if len(a) == 1 else a
        out.append(a)
    return tuple(out)


def _state_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _state_paths(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _state_paths(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_reference(ref_specs, arch, multi_pod):
    ref = ref_specs[(arch, multi_pod)]
    mesh = MESHES[multi_pod]
    cfg = get_config(arch)
    model = params_specs(cfg)
    layout = reference_layout(model)
    # the layout covers the reference's tree: each stacked leaf once a slot
    got_paths = {leaf.path: leaf.shape for leaf in layout.values()}
    assert got_paths == {p: tuple(s) for p, (s, _) in ref["params"].items()}
    for path, (shape, want) in ref["params"].items():
        assert _norm(param_spec(mesh, path, tuple(shape))) == _norm(want), path
    for path, (shape, want) in ref["opt"].items():
        assert _norm(opt_spec(mesh, path, tuple(shape))) == _norm(want), path
    for key, (shape, want) in ref["data"].items():
        assert _norm(data_spec(mesh, tuple(shape))) == _norm(want), key
    for name, spec in SHAPES.items():
        if spec.kind != "decode":
            continue
        assert set(batch_specs(cfg, spec)) == {k.split("/")[1] for k in ref["data"]
                                               if k.startswith(name + "/")}
        state = decode_state_specs(cfg, spec)
        for path, leaf in _state_paths(state):
            shape, want = ref["decode"][f"{name}/{path}"]
            assert tuple(leaf.shape) == tuple(shape), path
            assert _norm(decode_state_spec(mesh, path, tuple(shape))) == _norm(want), path
    # per-layer placements: the spec without the unit axis; moments whose
    # unit axis the reference shards keep its bytes a device
    p_sh, o_sh = param_shardings(mesh, model), opt_shardings(mesh, model)
    U_bytes = {}
    for name, leaf in layout.items():
        spec = param_spec(mesh, leaf.path, leaf.shape)
        assert p_sh[name] == to_placements(mesh, spec[1:] if leaf.stacked else spec), name
        ospec = opt_spec(mesh, leaf.path, leaf.shape)
        layer_shape = leaf.shape[1:] if leaf.stacked else leaf.shape
        if not leaf.stacked or ospec[0] is None:
            assert o_sh[name] == to_placements(mesh, ospec[1:] if leaf.stacked else ospec), name
        else:
            got = math.prod(local_shape(mesh, layer_shape, o_sh[name]))
            free = [d for d, ax in zip(layer_shape, ospec[1:]) if ax is None and d > 1]
            U_bytes.setdefault(leaf.path, [0, math.prod(local_shape(
                mesh, leaf.shape, to_placements(mesh, ospec))), free])[0] += got
    bsz = 32 if multi_pod else 16
    for path, (got, want, free) in U_bytes.items():
        assert got >= want, path
        if got != want:  # only where no free dim of the layer divides
            assert all(d % bsz for d in free), (path, free)


def test_placements_of_a_dim_over_two_mesh_dims():
    """("pod", "data") on one dim is a Shard of it on both mesh dims, the
    pod major: each device's block of rows is the reference's tiling."""
    mesh = MESHES[True]
    spec = (("pod", "data"), None, "model")
    pl = to_placements(mesh, spec)
    assert pl == (Shard(0), Shard(0), Shard(2))
    shape = (64, 3, 32)
    assert local_shape(mesh, shape, pl) == (2, 3, 2)
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    for coord in [(0, 0, 0), (0, 5, 3), (1, 0, 15), (1, 15, 7)]:
        lshape, offset = _compute_local_shape_and_global_offset(shape, mesh.shape, list(coord), pl)
        p, d, m = coord
        # JAX tiles ("pod", "data") as one flattened dim of 32, pod major
        assert tuple(lshape) == (2, 3, 2)
        assert tuple(offset) == ((p * 16 + d) * 2, 0, m * 2), coord
    assert to_placements(mesh, (None, None)) == (Replicate(),) * 3


def test_decode_state_shardings_tree():
    cfg = get_config("gemma2-2b")
    mesh = MESHES[False]
    state = decode_state_specs(cfg, SHAPES["long_500k"])
    sh = decode_state_shardings(mesh, state)
    # batch 1: the KV caches shard their sequence over data, heads or hd over model
    k = sh["layers"][1]["kv"]["k"]
    assert k[0] == Shard(1) and k[1] in (Shard(2), Shard(3))
    assert sh["pos"] == (Replicate(), Replicate())
    assert isinstance(torch.zeros(()), torch.Tensor)
