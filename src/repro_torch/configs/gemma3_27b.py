"""gemma3-27b — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family, 27b shape] 62 layers, d_model 5376,
32 query heads (head_dim 128) / 16 KV heads, GeGLU d_ff 21504, vocab
262144; every 6th layer is global (1M rope theta), others sliding
window 1024.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,
    activation="gelu",
    gated_mlp=True,
)
