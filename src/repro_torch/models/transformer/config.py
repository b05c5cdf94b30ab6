"""Architecture configuration for the LM pool (port of
``repro.models.transformer.config``).

One generic decoder implementation covers all six arch types via the
switches below; per-arch files in ``repro_torch/configs`` instantiate it
with the exact published hyperparameters (citations in each file).
Three fields steered JAX's compiler or mesh in the reference; on one
card they do this:

* ``remat``: activation checkpointing for training, at the reference's
  granularity: ``forward_hidden`` recomputes each unit of
  ``len(layer_pattern)`` layers, and each leftover layer, in the backward
  (``torch.utils.checkpoint``, non-reentrant).  Gradients are the same
  bits with it on or off.  Serving runs under ``torch.inference_mode()``
  and keeps no activations, so it has no effect there.
* ``seq_shard``: sequence-parallel residual stream over a mesh's model
  axis: ``shard_hint`` splits it so under the dry-run's mesh; a real run
  has no mesh, so there it has no effect.
* ``moe_groups``: routing groups.  The reference aligns them with the
  data shards; here they still split the tokens into groups that route
  on their own (top-k, capacity and sort within each group), so they
  change which tokens an expert takes, as they do in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                     # query heads (0 for pure SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention layout
    head_dim: Optional[int] = None     # default d_model // num_heads
    layer_pattern: tuple[str, ...] = ("global",)  # cycled: global|local|ssm|hybrid
    window: int = 4096                 # sliding-window size for 'local'
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None    # gemma2-style tanh capping
    logit_softcap: Optional[float] = None

    # mlp
    activation: str = "silu"           # silu | gelu | relu2
    gated_mlp: bool = True             # SwiGLU/GeGLU vs plain

    # moe
    num_experts: int = 0               # 0 = dense MLP
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    # routing groups: top-k + capacity + sort run independently inside
    # each group (in the reference, group dim = data shards, so dispatch
    # stays shard-local; here a loop over groups with the same routing)
    moe_groups: int = 1

    # ssm (mamba2 SSD)
    ssm_state: int = 0                 # N; 0 = no ssm
    ssm_heads: int = 0                 # SSD heads (default d_inner/64)
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # modality / structure
    frontend: Optional[str] = None     # None | 'audio' | 'vision'
    num_prefix_tokens: int = 0         # stub patch/frame prefix length
    enc_dec: bool = False              # whisper: cross-attend to encoder out
    enc_len: int = 1500                # encoder output length (audio frames)

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "float32"             # params/activations dtype name
    remat: bool = True                 # per-layer activation checkpointing
                                       # (training; no effect on serving)
    seq_shard: bool = False            # sequence-parallel residual stream
                                       # (needs a mesh; no effect here)

    # paper-technique transfer (DESIGN.md §4): deduplicated vocab-sharded
    # embedding gather with all-to-all — cooperative feature loading.
    cooperative_embed: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def layer_kind(self, l: int) -> str:
        return self.layer_pattern[l % len(self.layer_pattern)]

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer attends globally over the full sequence."""
        kinds = {self.layer_kind(l) for l in range(self.num_layers)}
        return "global" not in kinds or self.arch_type == "ssm"

    def reduced(self, **overrides) -> "ArchConfig":
        """2-layer, narrow smoke variant of the same family."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32 if self.num_heads else None,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            window=64,
            ssm_chunk=16,
            enc_len=32,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return replace(self, **small)


# canonical FLOP count helpers ------------------------------------------------
def param_count(cfg: ArchConfig) -> int:
    """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
    d, L = cfg.d_model, cfg.num_layers
    n = cfg.vocab_size * d  # embed (tied head)
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d
    for l in range(L):
        kind = cfg.layer_kind(l)
        if kind in ("global", "local", "hybrid"):
            q = d * cfg.num_heads * cfg.hd
            kv = 2 * d * cfg.num_kv_heads * cfg.hd
            o = cfg.num_heads * cfg.hd * d
            n += q + kv + o
        if kind in ("ssm", "hybrid") or cfg.arch_type == "ssm":
            di = cfg.d_inner
            n += d * 2 * di  # in_proj (x, z)
            n += di * (2 * cfg.ssm_state + cfg.n_ssm_heads)  # B, C, dt proj
            n += di * d  # out_proj
        if cfg.d_ff:
            mult = 3 if cfg.gated_mlp else 2
            if cfg.num_experts:
                n += cfg.num_experts * mult * d * cfg.d_ff + d * cfg.num_experts
            else:
                n += mult * d * cfg.d_ff
        if cfg.enc_dec:
            n += 4 * d * d  # cross-attention
    return int(n)


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: only top-k experts count)."""
    if not cfg.num_experts:
        return param_count(cfg)
    full = param_count(cfg)
    mult = 3 if cfg.gated_mlp else 2
    expert_params = cfg.num_layers * cfg.num_experts * mult * cfg.d_model * cfg.d_ff
    active_experts = cfg.num_layers * cfg.moe_top_k * mult * cfg.d_model * cfg.d_ff
    return int(full - expert_params + active_experts)
