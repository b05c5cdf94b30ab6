"""The LM pool in the port (configs, ``init_lm``, the forward, one serve step,
token batches, parameter counts) against the JAX package's.

Every architecture of ``ALL_ARCHS`` runs at its reduced size with the
reference's weights carried across (``lm_params_from_jax``): the
``forward_train`` logits and one ``make_serve_step`` step's logits and
caches within ``atol=1e-4``, ``pos`` equal.  ``init_lm`` must draw the
reference's weights bit for bit (floats compared as int32 views), and
``threefry.normal`` ``jax.random.normal``'s.  The decode path over a
prompt is held in ``tests/test_torch_lm_decode.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.data.tokens import synthetic_token_batch as j_synthetic_token_batch
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.models.transformer import forward_train as j_forward_train
from repro.models.transformer import init_decode_state as j_init_decode_state
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer.config import active_param_count as j_active_param_count
from repro.models.transformer.config import param_count as j_param_count
from repro_torch.configs import ALL_ARCHS, get_config, list_archs
from repro_torch.core import threefry
from repro_torch.data import synthetic_token_batch
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.transformer import (
    active_param_count,
    decode_state_from_jax,
    forward_train,
    init_decode_state,
    init_lm,
    lm_params_from_jax,
    param_count,
)

torch.set_num_threads(1)  # the suite runs files in parallel workers

ATOL = 1e-4
B, S = 2, 32


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.int32)


def test_registry_matches_reference():
    assert ALL_ARCHS == J_ALL_ARCHS and list_archs() == j_list_archs()
    for arch in ALL_ARCHS:
        got, want = get_config(arch), j_get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
        assert (got.hd, got.d_inner, got.n_ssm_heads, got.is_subquadratic) == (
            want.hd, want.d_inner, want.n_ssm_heads, want.is_subquadratic)
        assert [got.layer_kind(l) for l in range(got.num_layers)] == [
            want.layer_kind(l) for l in range(want.num_layers)]
        assert got.torch_dtype == torch.float32
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_match_reference(arch):
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (get_config(arch).reduced(), j_get_config(arch).reduced())):
        assert param_count(cfg) == j_param_count(jcfg)
        assert active_param_count(cfg) == j_active_param_count(jcfg)


def test_published_gemma2_2b_size():
    """The configuration ``chip_smoke.py`` serves at full width."""
    cfg = get_config("gemma2-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (26, 2304, 8, 4, 256, 9216, 256000)
    assert param_count(cfg) == 2_614_099_968  # without the norms


@pytest.mark.parametrize("seed,shape", [(0, (4, 64)), (5, (3, 200)), (1, (1, 7))])
def test_synthetic_token_batch_matches_reference(seed, shape):
    got = synthetic_token_batch(*shape, vocab=5000, seed=seed)
    want = j_synthetic_token_batch(*shape, vocab=5000, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
@pytest.mark.parametrize("shape", [(1 << 16,), (64, 256), (7, 13)])
def test_normal_matches_jax(seed, shape, monkeypatch):
    """``jax.random.normal`` float32: XLA's ``erf_inv`` bit for bit, and the
    same bits drawn in chunks (here of 1,000 counters)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = threefry.normal(threefry.prng_key(seed), shape)
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    monkeypatch.setattr(threefry, "CHUNK", 1000)
    assert torch.equal(threefry.normal(threefry.prng_key(seed), shape), got)


def test_erf_inv_edges_match_jax():
    x = np.concatenate([np.linspace(-1, 1, 4097, dtype=np.float32),
                        np.float32([0.0, -0.0, 1 - 2**-24, -1 + 2**-24, 0.4142, -0.4142])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(threefry.erf_inv(torch.from_numpy(x))),
                                  want.view(np.int32))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_lm_matches_jax_bits(arch):
    cfg = get_config(arch).reduced()
    want = lm_params_from_jax(jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(7),
                                                                 j_get_config(arch).reduced())),
                              cfg, device="cpu")
    got = init_lm(cfg, seed=7, device="cpu")
    got_p, want_p = dict(got.named_parameters()), dict(want.named_parameters())
    assert set(got_p) == set(want_p)
    for name, t in want_p.items():
        np.testing.assert_array_equal(_bits(got_p[name]), _bits(t), err_msg=name)


def _inputs(cfg, rng):
    toks = rng.integers(0, cfg.vocab_size, (B, S - cfg.num_prefix_tokens)).astype(np.int32)
    prefix = (rng.standard_normal((B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
              if cfg.num_prefix_tokens else None)
    enc = (rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
           if cfg.enc_dec else None)
    return toks, prefix, enc


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_and_serve_step_match_reference(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    lm = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks, prefix, enc = _inputs(cfg, np.random.default_rng(0))
    want, want_aux = j_forward_train(jp, jcfg, jnp.asarray(toks), _j(prefix), _j(enc))
    with torch.inference_mode():
        got, got_aux = forward_train(lm, cfg, _t(toks), _t(prefix), _t(enc))
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=0, atol=1e-6)

    jstate = j_init_decode_state(jcfg, B, 64)
    state = init_decode_state(cfg, B, 64, device="cpu")
    if cfg.enc_dec:
        jstate["enc_out"] = jnp.asarray(enc)
        state["enc_out"] = _t(enc)
    want, jstate = j_make_serve_step(jcfg)(jp, jstate, jnp.asarray(toks[:, :1]))
    got, state = make_serve_step(cfg)(lm, state, _t(toks[:, :1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert state["pos"].dtype == torch.int32 and int(state["pos"]) == int(jstate["pos"]) == 1
    ref = decode_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    for got_l, want_l in zip(state["layers"], ref["layers"]):
        assert got_l.keys() == want_l.keys()
        for part in got_l:
            for k in got_l[part]:
                assert got_l[part][k].shape == want_l[part][k].shape
                np.testing.assert_allclose(got_l[part][k].numpy(), want_l[part][k].numpy(),
                                           rtol=0, atol=ATOL, err_msg=f"{part}.{k}")
