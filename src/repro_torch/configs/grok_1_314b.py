"""grok-1-314b — 8-expert top-2 MoE decoder.

[hf:xai-org/grok-1] 64 layers, d_model 6144, 48 query heads / 8 KV
heads, MoE d_ff 32768 with 8 experts top-2, vocab 131072.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    layer_pattern=("global",),
    num_experts=8,
    moe_top_k=2,
    activation="gelu",
    gated_mlp=True,
    tie_embeddings=False,
)
