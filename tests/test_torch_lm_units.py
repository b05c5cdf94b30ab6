"""The LM pool's building blocks in the port (``repro_torch.models.transformer``)
against the JAX package's, on the same seeded numpy inputs and weights.

Floats are held within ``atol=1e-5``; the MoE routes (each token's experts,
each expert's token table) are integer state and must be equal, with the
capacity loose and binding and with 1 and 2 routing groups; the cooperative
embedding gather must give the plain lookup's hidden states exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.transformer import attention as j_attn
from repro.models.transformer import model as j_model
from repro.models.transformer import modules as j_mod
from repro.models.transformer import moe as j_moe
from repro.models.transformer import ssm as j_ssm
from repro_torch.configs import get_config
from repro_torch.models.transformer import attention, model, modules, moe, ssm

torch.set_num_threads(1)  # the suite runs files in parallel workers

ATOL = 1e-5


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=0, atol=atol)


def _weights(rng, shapes: dict, scale: float = 0.2) -> dict:
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


def _both(p: dict):
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}


def _cfgs(arch: str, **kw):
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def test_rms_norm_softcap_rope_mask():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    _close(modules.rms_norm(_t(x), _t(scale), 1e-6), j_mod.rms_norm(x, scale, 1e-6))
    _close(modules.softcap(_t(x * 20), 30.0), j_mod.softcap(jnp.asarray(x * 20), 30.0))
    pos = np.arange(37, dtype=np.int32)
    for theta in (10_000.0, 1_000_000.0):
        sin, cos = modules.rope_freqs(_t(pos), 32, theta)
        jsin, jcos = j_mod.rope_freqs(jnp.asarray(pos), 32, theta)
        _close(sin, jsin)
        _close(cos, jcos)
        q = rng.standard_normal((2, 37, 4, 32)).astype(np.float32)
        _close(modules.apply_rope(_t(q), sin[None], cos[None]),
               j_mod.apply_rope(jnp.asarray(q), jsin[None], jcos[None]))
    for window in (None, 5):
        np.testing.assert_array_equal(
            modules.causal_mask(_t(pos[:9]), _t(pos), window).numpy(),
            np.asarray(j_mod.causal_mask(jnp.asarray(pos[:9]), jnp.asarray(pos), window)))


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply(activation, gated):
    rng = np.random.default_rng(1)
    d, f = 48, 96
    shapes = {"w_up": (d, f), "w_down": (f, d)}
    if gated:
        shapes["w_gate"] = (d, f)
    jp, tp = _both(_weights(rng, shapes))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    _close(modules.mlp_apply(tp, _t(x), activation, gated),
           j_mod.mlp_apply(jp, jnp.asarray(x), activation, gated))


def _qkv(rng, B, S, H, hd):
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_flash_attention(window, cap):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 64, 2, 16)
    got = attention._flash_attention(_t(q), _t(k), _t(v), window, cap, block_k=16)
    want = j_attn._flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window,
                                   cap, block_k=16)
    _close(got, want)


@pytest.mark.parametrize("cap", [None, 50.0])
def test_banded_local_attention(cap):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 96, 2, 8)
    got = attention._banded_local_attention(_t(q), _t(k), _t(v), 16, cap)
    want = j_attn._banded_local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 16,
                                          cap)
    _close(got, want)


def _attn_weights(rng, cfg):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return _both(_weights(rng, {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
                                "wo": (H * hd, d)}, 0.1))


@pytest.mark.parametrize("arch,S,window", [("gemma2-2b", 32, None), ("gemma2-2b", 64, 16),
                                           ("granite-3-8b", 32, 8)])
def test_attention_train(arch, S, window):
    """Flash (S <= 2 * window or no window) and banded (S > 2 * window)
    dispatch, GQA repeat and softcap (gemma2)."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(4)
    jp, tp = _attn_weights(rng, cfg)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    _close(attention.attention_train(tp, cfg, _t(x), _t(pos), window),
           j_attn.attention_train(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), window))


@pytest.mark.parametrize("ring,S_c,window", [(False, 12, None), (False, 12, 4), (True, 6, 6)])
def test_attention_decode(ring, S_c, window):
    """Flat and ring caches over 15 steps: past the flat cache's end the
    slot clamps to ``S_c - 1`` (``dynamic_update_slice``), the ring wraps."""
    jcfg, cfg = _cfgs("gemma2-2b")
    rng = np.random.default_rng(5)
    jp, tp = _attn_weights(rng, cfg)
    B, KV, hd = 3, cfg.num_kv_heads, cfg.hd
    jcache = {"k": jnp.zeros((B, S_c, KV, hd)), "v": jnp.zeros((B, S_c, KV, hd))}
    tcache = {"k": torch.zeros((B, S_c, KV, hd)), "v": torch.zeros((B, S_c, KV, hd))}
    for step in range(15):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = j_attn.attention_decode(jp, jcfg, jnp.asarray(x), jcache,
                                               jnp.asarray(step, jnp.int32), window, ring=ring)
        got, tcache = attention.attention_decode(tp, cfg, _t(x), tcache,
                                                 torch.tensor(step, dtype=torch.int32),
                                                 window, ring=ring)
        _close(got, want)
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])


def test_cross_attention():
    jcfg, cfg = _cfgs("whisper-tiny")
    rng = np.random.default_rng(6)
    jp, tp = _attn_weights(rng, cfg)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    _close(attention.cross_attention(tp, cfg, _t(x), _t(enc)),
           j_attn.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(enc)))


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssm_train_and_decode(chunk):
    """The chunked SSD scan (carried state across 4 or 2 chunks) and 6
    recurrent decode steps with the conv and SSD states."""
    jcfg, cfg = _cfgs("mamba2-2.7b", ssm_chunk=chunk)
    pj = j_ssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    pt = {k: _t(v) for k, v in pj.items()}
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    _close(ssm.ssm_train(pt, cfg, _t(u)), j_ssm.ssm_train(pj, jcfg, jnp.asarray(u)))
    js, ts = j_ssm.init_ssm_state(jcfg, 2), ssm.init_ssm_state(cfg, 2, device="cpu")
    for t in range(6):
        want, js = j_ssm.ssm_decode(pj, jcfg, jnp.asarray(u[:, t:t + 1]), js)
        got, ts = ssm.ssm_decode(pt, cfg, _t(u[:, t:t + 1]), ts)
        _close(got, want)
        _close(ts["h"], js["h"])
        _close(ts["conv"], js["conv"])


def test_ssm_init_matches_jax_bits():
    _, cfg = _cfgs("hymba-1.5b")
    from repro_torch.core import threefry

    got = ssm.init_ssm(threefry.prng_key(3), cfg, device="cpu")
    want = j_ssm.init_ssm(jax.random.PRNGKey(3), j_get_config("hymba-1.5b").reduced())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().view(np.int32), _np(want[k]).view(np.int32))


def _j_routes(monkeypatch, p, cfg, xf):
    """The reference ``_moe_group``'s (expert, table_tok): ``jax.lax.top_k``'s
    indices and the table ``jnp.clip(table_tok, 0)`` reads, recorded."""
    seen = {}
    top_k, clip = jax.lax.top_k, jnp.clip

    def rec_top_k(x, k):
        seen["expert"] = top_k(x, k)[1]
        return top_k(x, k)

    def rec_clip(x, *a, **kw):
        if x.ndim == 2 and x.dtype == jnp.int32:
            seen["table_tok"] = x
        return clip(x, *a, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "clip", rec_clip)
    out, aux = j_moe._moe_group(p, cfg, xf)
    monkeypatch.undo()
    return out, aux, _np(seen["expert"]), _np(seen["table_tok"])


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("cap", [8.0, 0.25])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_and_routes(monkeypatch, arch, cap, groups):
    """Top-2 (grok) and top-1 (scout) routing, capacity loose (8.0) and
    binding (0.25: tokens dropped), 1 and 2 groups."""
    jcfg, cfg = _cfgs(arch, moe_capacity_factor=cap, moe_groups=groups)
    pj = j_moe.init_moe(jax.random.PRNGKey(1), jcfg)
    pt = {k: _t(v) for k, v in pj.items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    want, jaux = j_moe.moe_apply(pj, jcfg, jnp.asarray(x))
    got, taux = moe.moe_apply(pt, cfg, _t(x))
    _close(got, want)
    _close(taux, jaux)
    dropped = 0
    for xf in x.reshape(groups, -1, cfg.d_model):
        jout, _, expert, table_tok = _j_routes(monkeypatch, pj, jcfg, jnp.asarray(xf))
        r = moe.route(pt, cfg, _t(xf))
        np.testing.assert_array_equal(r.expert.numpy(), expert)
        np.testing.assert_array_equal(r.table_tok.numpy(), table_tok)
        dropped += xf.shape[0] * cfg.moe_top_k - int((table_tok >= 0).sum())
    assert (dropped > 0) == (cap < 1)


def test_moe_top_k_ties_go_to_the_lower_expert():
    _, cfg = _cfgs("grok-1-314b")
    p = {"router": torch.zeros((cfg.d_model, cfg.num_experts))}
    r = moe.route(p, cfg, torch.ones((5, cfg.d_model)))  # every probability equal
    assert r.expert.tolist() == [[0, 1]] * 5
    want = jax.lax.top_k(jnp.full((5, cfg.num_experts), 0.25), 2)[1]
    np.testing.assert_array_equal(r.expert.numpy(), _np(want))


def test_cooperative_embed_exact():
    """tokens.numel() > V: the deduplicated gather equals the plain lookup
    exactly, and the reference's within ``atol``."""
    jcfg, cfg = _cfgs("granite-3-8b", vocab_size=64)
    jp = j_model.init_lm(jax.random.PRNGKey(0), jcfg)
    lm = model.lm_params_from_jax(jax.tree.map(_np, jp), cfg, device="cpu")
    toks = np.random.default_rng(9).integers(0, 64, (4, 40)).astype(np.int32)
    coop = dataclasses.replace(cfg, cooperative_embed=True)
    with torch.no_grad():
        h1, _ = model.forward_hidden(lm, cfg, toks)
        h2, _ = model.forward_hidden(lm, coop, toks)
    assert torch.equal(h1, h2)
    want, _ = j_model.forward_hidden(jp, dataclasses.replace(jcfg, cooperative_embed=True),
                                     jnp.asarray(toks))
    _close(h2, want)
