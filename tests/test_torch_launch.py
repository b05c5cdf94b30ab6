"""Launch-layer units of the port against the JAX package's: the shape
grid and its specs, ``model_flops``, and the parameter, optimizer and
decode-state specs of all ten architectures at their published sizes on
the meta device (no allocation) against ``jax.eval_shape``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import roofline as j_roofline
from repro.launch import specs as j_specs
from repro.models.transformer.config import active_param_count as j_active_param_count
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch import roofline
from repro_torch.launch.roofline import model_flops
from repro_torch.launch.specs import (
    LONG_CONTEXT_OK,
    SHAPES,
    ShapeSpec,
    batch_specs,
    decode_state_specs,
    opt_specs,
    params_specs,
    shape_applicable,
)
from repro_torch.models.transformer import active_param_count

DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bfloat16: jax.numpy.bfloat16}


def _same(t: torch.Tensor, s) -> bool:
    return tuple(t.shape) == tuple(s.shape) and np.dtype(DTYPES[t.dtype]) == np.dtype(s.dtype)


def test_batch_specs_shapes():
    cfg = get_config("internvl2-26b")
    spec = SHAPES["train_4k"]
    b = batch_specs(cfg, spec)
    # vlm: 64 prefix patch embeddings + text fills the rest of seq_len
    assert b["tokens"].shape == (256, 4096 - 64)
    assert b["prefix_embeds"].shape == (256, 64, cfg.d_model)
    assert all(t.is_meta for t in b.values())

    cfg_w = get_config("whisper-tiny")
    bw = batch_specs(cfg_w, SHAPES["prefill_32k"])
    assert bw["enc_out"].shape == (32, cfg_w.enc_len, cfg_w.d_model)


def test_batch_specs_match_reference():
    for arch in ALL_ARCHS:
        for name, spec in SHAPES.items():
            got = batch_specs(get_config(arch), spec)
            want = j_specs.batch_specs(j_get_config(arch), j_specs.SHAPES[name])
            assert sorted(got) == sorted(want)
            assert all(_same(got[k], want[k]) for k in got), (arch, name)
    assert SHAPES == {k: ShapeSpec(*vars(v).values()) for k, v in j_specs.SHAPES.items()}
    assert LONG_CONTEXT_OK == j_specs.LONG_CONTEXT_OK


def test_shape_applicability_matrix():
    long_ok = {a for a in ALL_ARCHS if shape_applicable(get_config(a), "long_500k")[0]}
    assert long_ok == {"mamba2-2.7b", "hymba-1.5b", "gemma2-2b", "gemma3-27b"}
    for a in ALL_ARCHS:  # every other shape applies to every arch
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert shape_applicable(get_config(a), s)[0]
        for s in SHAPES:
            assert shape_applicable(get_config(a), s) == j_specs.shape_applicable(
                j_get_config(a), s)


def test_model_flops_formulas():
    cfg = get_config("granite-3-8b")
    n = active_param_count(cfg)
    t = model_flops(cfg, SHAPES["train_4k"], n)
    assert t == 6.0 * n * 256 * 4096
    d = model_flops(cfg, SHAPES["decode_32k"], n)
    assert d == 2.0 * n * 128
    for arch in ALL_ARCHS:
        n = active_param_count(get_config(arch))
        assert n == j_active_param_count(j_get_config(arch))
        for name, spec in SHAPES.items():
            assert model_flops(get_config(arch), spec, n) == j_roofline.model_flops(
                j_get_config(arch), j_specs.SHAPES[name], n)
    # the H100's: float32 outside the tensor cores, HBM3
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (67e12, 3.35e12)


def test_roofline_record_matches_reference():
    """The ``Roofline`` record keeps the reference's fields, in its order,
    and ``to_dict`` gives the reference's dict for the same values."""
    values = dict(flops_per_dev=1.5e15, hbm_bytes_per_dev=2.5e12, coll_bytes_per_dev=3.0e9,
                  compute_s=0.75, memory_s=0.5, collective_s=0.06, bottleneck="compute",
                  model_flops_global=1.2e17, useful_ratio=0.8,
                  coll_detail={"all-gather": 2.0e9, "all-reduce": 1.0e9},
                  peak_mem_bytes=6.4e10)
    got = roofline.Roofline(**values).to_dict()
    want = j_roofline.Roofline(**values).to_dict()
    assert list(got) == list(want) and got == want


def _layer_specs(want: dict, cfg, l: int) -> dict:
    """Layer ``l``'s ``ShapeDtypeStruct``s in the reference's stacked layout
    (``layer_params`` indexes arrays, these are not): ``{path: spec}``."""
    p_len = len(cfg.layer_pattern)
    n_units = cfg.num_layers // p_len
    unit = l < n_units * p_len
    tree = want["blocks"][l % p_len] if unit else want["tail"][l - n_units * p_len]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if unit:
            assert leaf.shape[0] == n_units
            leaf = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
        out["/".join(str(p.key) for p in path)] = leaf
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_specs_match_eval_shape(arch):
    """Published sizes: every parameter on the meta device, with the shape
    and dtype ``jax.eval_shape(init_lm)`` gives it, layer by layer."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model = params_specs(cfg)
    want = j_specs.params_specs(jcfg)
    params = list(model.parameters())
    assert all(p.is_meta for p in params)
    for k in ("embed", "final_norm", "unembed"):
        assert hasattr(model, k) == (k in want)
        if k in want:
            assert _same(getattr(model, k), want[k])
    assert len(model.layers) == cfg.num_layers
    for l, layer in enumerate(model.layers):
        flat = _layer_specs(want, jcfg, l)
        got = {n.replace(".", "/"): p for n, p in layer.named_parameters()}
        assert sorted(got) == sorted(flat), (arch, l)
        assert all(_same(got[k], flat[k]) for k in got), (arch, l)
    opt = opt_specs(model)
    assert opt.step == 0 and len(opt.mu) == len(opt.nu) == len(params)
    assert all(m.is_meta and m.shape == p.shape and m.dtype == torch.float32
               for m, p in zip(opt.mu + opt.nu, params + params))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "gemma2-2b", "whisper-tiny", "mamba2-2.7b"])
def test_decode_state_specs_match_eval_shape(arch):
    spec = SHAPES["decode_32k"]
    got = decode_state_specs(get_config(arch), spec)
    want = j_specs.decode_state_specs(j_get_config(arch), j_specs.SHAPES["decode_32k"])
    g = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in g}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    mine = dict(walk(got))
    assert sorted(mine) == sorted(flat)
    assert all(t.is_meta and _same(t, flat[k]) for k, t in mine.items())
