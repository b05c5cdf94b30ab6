"""llama4-scout-17b-a16e — 16-expert top-1 MoE with early-fusion vision.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48 layers, d_model 5120, 40 query
heads / 8 KV heads, MoE d_ff 8192 with 16 experts top-1, vocab 202048.
Early fusion: image patch embeddings (STUB per the brief) are prepended
to the token stream as 64 prefix tokens.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=("global",),
    num_experts=16,
    moe_top_k=1,
    activation="silu",
    gated_mlp=True,
    frontend="vision",
    num_prefix_tokens=64,
    tie_embeddings=False,
)
