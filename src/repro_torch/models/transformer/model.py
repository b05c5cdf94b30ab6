"""Generic decoder LM covering the assigned architecture pool; port of
``repro.models.transformer.model``.

Block kinds (``cfg.layer_pattern``):
  global        full causal GQA attention
  local         sliding-window GQA attention (window = cfg.window)
  ssm           Mamba-2 SSD mixer (attention-free)
  hybrid        parallel attention (windowed) + SSD heads, mean-fused (hymba)
  hybrid_global hybrid with full attention (hymba's few global layers)

MLP: dense (SwiGLU / GeGLU / squared-ReLU) or MoE (grok-1, llama4-scout).
Frontends (audio/vision) are stubs: callers pass precomputed frame/patch
embeddings; whisper additionally cross-attends to a stub-encoded audio
context (enc-dec).

The reference stacks the layers of each pattern slot into a scan unit
(``blocks[s]`` with a leading axis); :class:`LM` holds one :class:`Block`
a layer and loops over them (:func:`layer_params` and
:func:`lm_params_to_jax` map one layout to the other).  With
``cfg.remat`` and autograd on, :func:`forward_hidden` checkpoints the
reference's units (``torch.utils.checkpoint``, the port's
``jax.checkpoint``).  Serving (:func:`forward_prefill`,
:func:`forward_decode`, :func:`prefill_decode`) runs under
``torch.inference_mode()``, which keeps no activations, so ``cfg.remat``
has no effect there.

As the JAX package jits its serve step, :func:`decode_step` runs
:func:`forward_decode` as one program a model, batch size and cache
length (:func:`decode_program`, a
:class:`repro_torch.engine.compiled.CompiledFunction`): on a card one
captured CUDA graph that reads and writes the decode state in place (its
caches and device ``pos``), so consecutive steps on one state replay it
with no host work but the launch.  :func:`prefill_decode` replays the
same program once a prompt position, so prefill equals stepping bit for
bit by construction.  The CPU runs the same body eagerly.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import threefry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gather import gather
from repro_torch.kernels.unique_compact import unique_with_inverse
from repro_torch.models.transformer.attention import (
    attention_decode,
    attention_train,
    cross_attention,
    init_attention,
)
from repro_torch.models.transformer import modules
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.modules import (
    init_mlp,
    mlp_apply,
    rms_norm,
    scaled_normal,
    shard_hint,
    softcap,
)
from repro_torch.models.transformer.moe import init_moe, moe_apply
from repro_torch.models.transformer.ssm import (
    init_ssm,
    init_ssm_state,
    ssm_decode,
    ssm_train,
)

ATTN_KINDS = ("global", "local", "hybrid", "hybrid_global")
SSM_KINDS = ("ssm", "hybrid", "hybrid_global")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
class Block(nn.Module):
    """One decoder layer: its norms as parameters, each sub-block
    (``attn``, ``ssm``, ``cross``, ``mlp``, ``moe``) an ``nn.ParameterDict``.
    ``block["attn"]["wq"]`` reads as the reference's per-layer pytree."""

    def __init__(self, kind: str, params: dict):
        super().__init__()
        self.kind = kind
        for name, value in params.items():
            if isinstance(value, dict):
                self.add_module(name, nn.ParameterDict(
                    {k: nn.Parameter(v) for k, v in value.items()}))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


class LM(nn.Module):
    """The decoder's parameters: ``embed`` (V, d), ``final_norm``, an
    ``unembed`` (d, V) unless the embeddings are tied, and one
    :class:`Block` a layer.  Calling it runs :func:`forward_train`."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"])
        if "unembed" in params:
            self.unembed = nn.Parameter(params["unembed"])
        self.layers = nn.ModuleList(
            Block(cfg.layer_kind(l), lp) for l, lp in enumerate(params["layers"]))

    def forward(self, tokens, prefix_embeds=None, enc_out=None):
        return forward_train(self, self.cfg, tokens, prefix_embeds, enc_out)


def _num_units(cfg: ArchConfig) -> tuple[int, int]:
    """The reference's scan units: ``n_units`` full pattern periods, then
    ``tail`` leftover layers."""
    p = len(cfg.layer_pattern)
    return cfg.num_layers // p, cfg.num_layers % p


def _init_layer(key: torch.Tensor, cfg: ArchConfig, kind: str, device) -> dict:
    d = cfg.d_model
    k1, k2, k3, k4 = threefry.split(key, 4)
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)  # noqa: E731
    lp: dict = {"norm1": zeros()}
    if kind in ATTN_KINDS:
        lp["attn"] = init_attention(k1, cfg, device=device)
    if kind in SSM_KINDS:
        lp["ssm"] = init_ssm(k2, cfg, device=device)
        if kind != "ssm":
            lp["norm_ssm"] = zeros()
    if cfg.enc_dec:
        lp["cross"] = init_attention(k3, cfg, cross=True, device=device)
        lp["norm_cross"] = zeros()
    if cfg.d_ff:
        lp["norm2"] = zeros()
        if cfg.num_experts:
            lp["moe"] = init_moe(k4, cfg, device=device)
        else:
            lp["mlp"] = init_mlp(k4, d, cfg.d_ff, cfg.gated_mlp, device=device)
    return lp


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def init_lm(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> LM:
    """The weights of the JAX package's ``init_lm(PRNGKey(seed), cfg)``,
    bit for bit: the same key splits and ``jax.random.normal`` draws
    (:mod:`repro_torch.core.threefry`), made on ``device`` (CUDA unless
    ``device="cpu"``).  A ``bfloat16`` config gets the float32 draws
    rounded, not JAX's bfloat16 draw."""
    return LM(cfg, _init_params(cfg, seed, resolve_device(device)))


def _init_params(cfg: ArchConfig, seed: int, dev: torch.device) -> dict:
    """:func:`init_lm`'s parameter tree on ``dev``; on the meta device
    (``launch.specs.params_specs``) the weights are not drawn
    (``threefry.normal`` gives the shape only)."""
    d, V = cfg.d_model, cfg.vocab_size
    key, ke = threefry.split(threefry.prng_key(seed))
    params: dict = {
        "embed": scaled_normal(ke, (V, d), 0.02, dev),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        key, ku = threefry.split(key)
        params["unembed"] = scaled_normal(ku, (d, V), 0.02, dev)
    n_units, tail = _num_units(cfg)
    p_len = len(cfg.layer_pattern)
    slots = []
    for s in range(p_len):
        per_unit = []
        for _ in range(n_units):
            key, kl = threefry.split(key)
            per_unit.append(_init_layer(kl, cfg, cfg.layer_pattern[s], dev))
        slots.append(per_unit)
    layers = [slots[l % p_len][l // p_len] for l in range(n_units * p_len)]
    for t in range(tail):
        key, kl = threefry.split(key)
        layers.append(_init_layer(kl, cfg, cfg.layer_pattern[t], dev))
    params["layers"] = layers
    if cfg.torch_dtype != torch.float32:
        params = _tree_map(lambda t: t.to(cfg.torch_dtype), params)
    return params


def layer_params(params: dict, cfg: ArchConfig, l: int) -> dict:
    """Layer ``l``'s view of the reference's stacked layout (``blocks[s]``
    indexed at unit ``u``, or ``tail``)."""
    n_units, _ = _num_units(cfg)
    p_len = len(cfg.layer_pattern)
    if l < n_units * p_len:
        u, s = divmod(l, p_len)
        return _tree_map(lambda x: x[u], params["blocks"][s])
    return params["tail"][l - n_units * p_len]


def _to_tensor(device):
    return lambda a: torch.tensor(np.asarray(a), device=device)


def lm_params_from_jax(params_np: dict, cfg: ArchConfig, device: DeviceLike = None) -> LM:
    """The reference's parameter pytree (arrays as numpy) as an :class:`LM`
    on ``device`` that computes the same function."""
    dev = resolve_device(device)
    params = {k: _to_tensor(dev)(params_np[k]) for k in ("embed", "final_norm", "unembed")
              if k in params_np}
    params["layers"] = [_tree_map(_to_tensor(dev), layer_params(params_np, cfg, l))
                        for l in range(cfg.num_layers)]
    return LM(cfg, params)


def lm_params_to_jax(model: LM, cfg: ArchConfig) -> dict:
    """The inverse of :func:`lm_params_from_jax`: the reference's parameter
    pytree (numpy arrays, on the host) of ``model``, each pattern slot's
    layers stacked over the units into ``blocks[s]`` and the leftover
    layers in ``tail``."""
    def arrays(module: nn.Module) -> dict:
        out: dict = {}
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = p.detach().cpu().numpy()
        return out

    layers = [arrays(lp) for lp in model.layers]
    n_units, _ = _num_units(cfg)
    p_len = len(cfg.layer_pattern)
    params = {k: getattr(model, k).detach().cpu().numpy()
              for k in ("embed", "final_norm", "unembed") if hasattr(model, k)}

    def stack(units: list):
        if isinstance(units[0], dict):
            return {k: stack([u[k] for u in units]) for k in units[0]}
        return np.stack(units)

    params["blocks"] = [stack(layers[s:n_units * p_len:p_len])
                        for s in range(p_len)] if n_units else []
    params["tail"] = layers[n_units * p_len:]
    return params


def decode_state_from_jax(state_np: dict, device: DeviceLike = None) -> dict:
    """The reference's decode state (arrays as numpy) as the port's."""
    return _tree_map(_to_tensor(resolve_device(device)), state_np)


def _attn_window(cfg: ArchConfig, kind: str) -> Optional[int]:
    return cfg.window if kind in ("local", "hybrid") else None


def _unembed(model: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    logits = h @ w
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


# --------------------------------------------------------------------------
# training / prefill forward (full sequence)
# --------------------------------------------------------------------------
class _CooperativeEmbed(torch.autograd.Function):
    """``embed[tokens]`` read the cooperative way: each distinct id's row
    once (``unique_compact`` for the dedup and its inverse, ``gather`` for
    the rows), then expanded by the inverse (``gather`` again).  Rows are
    copied, so the output equals ``embed[tokens]`` bit for bit.  The
    backward is plain torch, as the reference's is XLA's AD of ``unique``
    and a gather: the output gradient summed into the table by the tokens.
    Nothing here sizes a tensor from the data, so neither direction waits
    on the host.
    """

    @staticmethod
    def forward(ctx, embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        V = embed.shape[0]
        uniq, inv = unique_with_inverse(tokens.reshape(-1).to(torch.int32).contiguous(), cap=V)
        rows = gather(embed, uniq)                       # (V, d), INVALID slots zero
        ctx.save_for_backward(tokens)
        ctx.table_shape = embed.shape
        return gather(rows, inv).reshape(*tokens.shape, embed.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        V, d = ctx.table_shape
        g_embed = torch.zeros((V, d), dtype=g.dtype, device=g.device)
        g_embed.index_add_(0, tokens.reshape(-1).long(), g.reshape(-1, d))
        return g_embed, None


def _embed_tokens(model: LM, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.cooperative_embed and tokens.numel() > cfg.vocab_size:
        # Cooperative embedding gather (the paper's deduplicated feature
        # loading on the vocabulary table), through the unique_compact and
        # gather kernels (their plain versions on the CPU).  The reference
        # pads the unique ids with V - 1, the port with INVALID; the rows
        # the tokens read are the same.
        return _CooperativeEmbed.apply(model.embed, tokens)
    return _embed_rows(model, tokens)


def _embed_rows(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``.  Under a mesh (the dry-run) a vocabulary-sharded
    table is read as DTensor's embedding does it, each shard's rows masked
    and the rows summed over the model dim at once, as GSPMD lowers the
    gather (DTensor's indexing would move the table instead)."""
    if modules._LOGICAL_MESH is not None:
        return shard_hint(F.embedding(tokens, model.embed), "batch", None, None)
    return model.embed[tokens]


def _block(lp: Block, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
           enc_out: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    kind = lp.kind
    # keep the residual stream batch-sharded (and optionally sequence-sharded
    # over the model dim) under a registered mesh; a no-op without one.  The
    # port also hints after each mixer: a DTensor matmul cannot take an
    # input split over both batch and sequence, which a small output
    # projection's cheapest strategy (all-gather the weight) leaves behind.
    hint = ("batch", "seq" if cfg.seq_shard else None, None)
    h = shard_hint(h, *hint)
    a2 = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "ssm":
        h = h + ssm_train(lp["ssm"], cfg, rms_norm(h, lp["norm1"], cfg.norm_eps))
    elif kind in ("hybrid", "hybrid_global"):
        a = attention_train(lp["attn"], cfg, rms_norm(h, lp["norm1"], cfg.norm_eps),
                            positions, _attn_window(cfg, kind))
        s = ssm_train(lp["ssm"], cfg, rms_norm(h, lp["norm_ssm"], cfg.norm_eps))
        h = h + 0.5 * (a + s)
    else:
        h = h + attention_train(lp["attn"], cfg, rms_norm(h, lp["norm1"], cfg.norm_eps),
                                positions, _attn_window(cfg, kind))
    h = shard_hint(h, *hint)
    if cfg.enc_dec and enc_out is not None:
        h = h + cross_attention(lp["cross"], cfg, rms_norm(h, lp["norm_cross"], cfg.norm_eps),
                                enc_out)
        h = shard_hint(h, *hint)
    if cfg.d_ff:
        x2 = rms_norm(h, lp["norm2"], cfg.norm_eps)
        if cfg.num_experts:
            y, a2 = moe_apply(lp["moe"], cfg, x2)
            h = h + y
        else:
            h = h + mlp_apply(lp["mlp"], x2, cfg.activation, cfg.gated_mlp)
    return h, a2


def forward_hidden(
    model: LM,
    cfg: ArchConfig,
    tokens,                                        # (B, S_text)
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, n_prefix, d) vlm/audio
    enc_out: Optional[torch.Tensor] = None,        # (B, enc_len, d) whisper
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final-norm hidden states (B, S_total, d), moe_aux scalar)."""
    dev = model.embed.device
    h = _embed_tokens(model, cfg, torch.as_tensor(tokens, device=dev))
    if prefix_embeds is not None:
        h = torch.cat([torch.as_tensor(prefix_embeds, device=dev).to(h.dtype), h], dim=1)
    if enc_out is not None:
        enc_out = torch.as_tensor(enc_out, device=dev)
    positions = torch.arange(h.shape[1], device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    # the reference's scan units (one pattern period each), then the tail
    # layers one by one: with remat each group is recomputed in the backward
    n_units, _ = _num_units(cfg)
    p_len = len(cfg.layer_pattern)
    groups = [model.layers[u * p_len:(u + 1) * p_len] for u in range(n_units)]
    groups += [[lp] for lp in model.layers[n_units * p_len:]]

    def run(h, aux, *, group):
        for lp in group:
            h, a2 = _block(lp, cfg, h, positions, enc_out)
            aux = aux + a2
        return h, aux

    remat = cfg.remat and torch.is_grad_enabled()
    for group in groups:
        if remat:
            # nothing here draws random numbers: no RNG state to keep (a
            # captured train step could not read it)
            h, aux = checkpoint(run, h, aux, group=group, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = run(h, aux, group=group)
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    return h, aux / max(cfg.num_layers, 1)


def forward_train(
    model: LM,
    cfg: ArchConfig,
    tokens,
    prefix_embeds: Optional[torch.Tensor] = None,
    enc_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full logits (B, S_total, V) — small-scale/eval use only."""
    h, aux = forward_hidden(model, cfg, tokens, prefix_embeds, enc_out)
    return _unembed(model, cfg, h), aux


@torch.inference_mode()
def forward_prefill(
    model: LM,
    cfg: ArchConfig,
    tokens,
    prefix_embeds: Optional[torch.Tensor] = None,
    enc_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward; returns (last-position logits (B, V), moe aux).
    Only the last position is unembedded (the reference slices the full
    (B, S, V) logits; the rows are the same products)."""
    h, aux = forward_hidden(model, cfg, tokens, prefix_embeds, enc_out)
    return _unembed(model, cfg, h[:, -1]), aux


# --------------------------------------------------------------------------
# decode state
# --------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> dict:
    """Zero KV/SSM caches for a ``max_len`` decode session, on ``device``
    (CUDA unless ``device="cpu"``); local layers get ring caches of
    ``min(window, max_len)`` slots."""
    return _decode_state(cfg, batch, max_len, resolve_device(device))


def _decode_state(cfg: ArchConfig, batch: int, max_len: int, dev: torch.device) -> dict:
    """:func:`init_decode_state` on ``dev`` (the meta device for
    ``launch.specs.decode_state_specs``)."""
    KV, hd, dt = cfg.num_kv_heads, cfg.hd, cfg.torch_dtype

    def kv(length: int) -> dict:
        return {"k": torch.zeros((batch, length, KV, hd), dtype=dt, device=dev),
                "v": torch.zeros((batch, length, KV, hd), dtype=dt, device=dev)}

    layers = []
    for l in range(cfg.num_layers):
        kind = cfg.layer_kind(l)
        st: dict = {}
        if kind in ("global", "hybrid_global"):
            st["kv"] = kv(max_len)
        elif kind in ("local", "hybrid"):
            st["kv"] = kv(min(cfg.window, max_len))
        if kind in SSM_KINDS:
            st["ssm"] = init_ssm_state(cfg, batch, device=dev)
        layers.append(st)
    state = {"pos": torch.zeros((), dtype=torch.int32, device=dev), "layers": layers}
    if cfg.enc_dec:
        state["enc_out"] = torch.zeros((batch, cfg.enc_len, cfg.d_model), dtype=dt, device=dev)
    return state


def _is_ring(cfg: ArchConfig, kind: str, cache_len: int) -> bool:
    return kind in ("local", "hybrid") and cache_len <= cfg.window


# --------------------------------------------------------------------------
# decode forward (one token)
# --------------------------------------------------------------------------
@torch.inference_mode()
def forward_decode(model: LM, cfg: ArchConfig, state: dict, token) -> tuple[torch.Tensor, dict]:
    """One-token step (token (B, 1)) with KV/SSM caches: returns (logits
    (B, V), state).  The KV caches are updated in place (the returned
    state holds the same tensors; the one passed in is consumed); the
    position stays on the device, so the step never waits on the host."""
    h = _embed_rows(model, torch.as_tensor(token, device=model.embed.device))  # (B, 1, d)
    pos = state["pos"]
    new_layers = []
    for lp, old in zip(model.layers, state["layers"]):
        kind = lp.kind
        st = dict(old)
        if kind == "ssm":
            y, st["ssm"] = ssm_decode(lp["ssm"], cfg, rms_norm(h, lp["norm1"], cfg.norm_eps),
                                      st["ssm"])
            h = h + y
        else:
            ring = _is_ring(cfg, kind, st["kv"]["k"].shape[1])
            a, st["kv"] = attention_decode(
                lp["attn"], cfg, rms_norm(h, lp["norm1"], cfg.norm_eps),
                st["kv"], pos, _attn_window(cfg, kind), ring=ring,
            )
            if kind in ("hybrid", "hybrid_global"):
                s, st["ssm"] = ssm_decode(
                    lp["ssm"], cfg, rms_norm(h, lp["norm_ssm"], cfg.norm_eps), st["ssm"])
                h = h + 0.5 * (a + s)
            else:
                h = h + a
        if cfg.enc_dec:
            h = h + cross_attention(lp["cross"], cfg,
                                    rms_norm(h, lp["norm_cross"], cfg.norm_eps),
                                    state["enc_out"])
        if cfg.d_ff:
            x2 = rms_norm(h, lp["norm2"], cfg.norm_eps)
            if cfg.num_experts:
                y, _ = moe_apply(lp["moe"], cfg, x2)
                h = h + y
            else:
                h = h + mlp_apply(lp["mlp"], x2, cfg.activation, cfg.gated_mlp)
        new_layers.append(st)
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    logits = _unembed(model, cfg, h)[:, 0, :]  # (B, V)
    new_state = dict(state)
    new_state["layers"] = new_layers
    new_state["pos"] = pos + 1
    return logits, new_state


# --------------------------------------------------------------------------
# the decode step as one program; prefill: the program over a whole prompt
# --------------------------------------------------------------------------
_DECODE_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def decode_program(model: LM, cfg: ArchConfig):
    """:func:`forward_decode` of ``model`` as a program keyed by ``(batch,
    cache length)``, the decode state passed by reference: a call writes
    the new state into the state's own tensors and returns the logits.  A
    captured CUDA graph a key and state on a card (the first call of each
    the eager warm-up); eager on the CPU.  One per model and config, kept
    while the model lives."""
    # the engine's package imports this one
    from repro_torch.engine.compiled import CompiledFunction, tensor_leaves

    programs = _DECODE_PROGRAMS.setdefault(model, {})
    if cfg not in programs:
        ref = weakref.ref(model)  # the cache must not keep the model alive

        @torch.inference_mode()
        def body(state: dict, token: torch.Tensor) -> torch.Tensor:
            logits, new = forward_decode(ref(), cfg, state, token)
            for dst, src in zip(tensor_leaves(state), tensor_leaves(new), strict=True):
                if dst is not src:
                    dst.copy_(src)
            return logits

        programs[cfg] = CompiledFunction("serve_step", body, state_args=(0,),
                                         capture=model.embed.device.type == "cuda")
    return programs[cfg]


def decode_step(model: LM, cfg: ArchConfig, state: dict, token) -> tuple[torch.Tensor, dict]:
    """:func:`forward_decode` through :func:`decode_program`: ``(logits (B,
    V), state)``, the state updated in place (the same dict and tensors)."""
    token = torch.as_tensor(token, device=model.embed.device).to(torch.int32)
    kv = [lay["kv"]["k"].shape[1] for lay in state["layers"] if "kv" in lay]
    key = (token.shape[0], max(kv, default=0))
    return decode_program(model, cfg)(key, state, token), state


def prefill_decode(model: LM, cfg: ArchConfig, state: dict, tokens) -> tuple[torch.Tensor, dict]:
    """Prompt prefill (tokens (B, S0)) against the decode caches: one
    :func:`decode_step` a prompt position (on a card a replay of the serve
    step's graph), so the caches, state and logits are bit-identical to
    stepping the serve step token by token.  Returns the last prompt
    position's logits ``(B, V)`` and the state (updated in place)."""
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = decode_step(model, cfg, state, tokens[:, t:t + 1])
    return logits, state
