"""granite-3-8b — dense GQA decoder.

[hf:ibm-granite/granite-3.0-2b-base family, 8b shape] 40 layers,
d_model 4096, 32 query heads / 8 KV heads (GQA), SwiGLU d_ff 12800,
vocab 49155.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    layer_pattern=("global",),
    activation="silu",
    gated_mlp=True,
)
