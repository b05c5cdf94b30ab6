"""The LM pool's decode path in the port against the JAX package's.

For every architecture (reduced, the reference's weights carried across):
``prefill_decode`` over a prompt against the reference's (jitted, as
``examples/serve_lm.py`` runs it), logits and caches within
``atol=1e-4``, ``pos`` equal, and the greedy tokens that follow equal.
In the port alone, as the reference's tests hold it: prefill bit-identical
to stepping ``make_serve_step`` (logits, every cache, the greedy tokens),
and teacher-forced ``forward_train`` logits within ``3e-3`` of stepped
decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.models.transformer import init_decode_state as j_init_decode_state
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import prefill_decode as j_prefill_decode
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.transformer import (
    decode_state_from_jax,
    forward_train,
    init_decode_state,
    init_lm,
    lm_params_from_jax,
    prefill_decode,
)

torch.set_num_threads(1)  # the suite runs files in parallel workers

ATOL = 1e-4
B, S0, NEW = 2, 12, 6


def _leaves(state: dict) -> list:
    out = [state["pos"]]
    for layer in state["layers"]:
        for part in sorted(layer):
            out += [layer[part][k] for k in sorted(layer[part])]
    return out


def _greedy(step, params, logits, state, n: int, argmax, to_np) -> np.ndarray:
    out = []
    tok = argmax(logits)
    for _ in range(n):
        out.append(to_np(tok)[:, 0])
        logits, state = step(params, state, tok)
        tok = argmax(logits)
    return np.stack(out, 1)


def _t_argmax(logits):
    return torch.argmax(logits, -1)[:, None].to(torch.int32)


def _j_argmax(logits):
    return jnp.argmax(logits, -1)[:, None].astype(jnp.int32)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_matches_reference(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = j_init_lm(jax.random.PRNGKey(3), jcfg)
    lm = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    jstate = j_init_decode_state(jcfg, B, S0 + NEW)
    state = init_decode_state(cfg, B, S0 + NEW, device="cpu")
    if cfg.enc_dec:
        enc = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
        jstate["enc_out"], state["enc_out"] = jnp.asarray(enc), torch.from_numpy(enc)
    want, jstate = jax.jit(lambda p, st, t: j_prefill_decode(p, jcfg, st, t))(
        jp, jstate, jnp.asarray(toks))
    got, state = prefill_decode(lm, cfg, state, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    ref = decode_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    assert int(state["pos"]) == int(ref["pos"]) == S0
    for a, b in zip(_leaves(state), _leaves(ref), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)
    gen = _greedy(make_serve_step(cfg), lm, got, state, NEW, _t_argmax, lambda t: t.numpy())
    jgen = _greedy(jax.jit(j_make_serve_step(jcfg)), jp, want, jstate, NEW, _j_argmax, np.asarray)
    np.testing.assert_array_equal(gen, jgen)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b", "gemma2-2b"])
def test_prefill_decode_bit_identical_to_stepping(arch):
    """The reference test's three architectures (window 8: ring caches wrap
    inside the prompt)."""
    cfg = get_config(arch).reduced(ssm_chunk=8, window=8)
    lm = init_lm(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S0)))
    serve = make_serve_step(cfg)
    logits_a, state_a = prefill_decode(lm, cfg, init_decode_state(cfg, B, S0 + NEW, "cpu"), toks)
    state_b = init_decode_state(cfg, B, S0 + NEW, "cpu")
    for t in range(S0):
        logits_b, state_b = serve(lm, state_b, toks[:, t:t + 1])
    assert torch.equal(logits_a, logits_b)
    for a, b in zip(_leaves(state_a), _leaves(state_b), strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        _greedy(serve, lm, logits_a, state_a, NEW, _t_argmax, lambda t: t.numpy()),
        _greedy(serve, lm, logits_b, state_b, NEW, _t_argmax, lambda t: t.numpy()))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b", "gemma2-2b", "gemma3-27b"])
def test_train_decode_consistency(arch):
    """Sequential decode reproduces teacher-forced logits (the reference
    test's four architectures and bound)."""
    cfg = get_config(arch).reduced(ssm_chunk=8, window=8)
    lm = init_lm(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 16)))
    with torch.inference_mode():
        logits, _ = forward_train(lm, cfg, toks)
    state = init_decode_state(cfg, B, 16, device="cpu")
    serve = make_serve_step(cfg)
    outs = []
    for t in range(16):
        lg, state = serve(lm, state, toks[:, t:t + 1])
        outs.append(lg)
    err = float((logits - torch.stack(outs, 1)).abs().max())
    assert err < 3e-3, err
