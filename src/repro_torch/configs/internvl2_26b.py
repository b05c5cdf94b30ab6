"""internvl2-26b — VLM: InternViT frontend (stub) + InternLM2 decoder.

[arXiv:2404.16821] InternVL 1.5/2 series.  Language backbone: 48 layers,
d_model 6144, 48 query heads / 8 KV heads, SwiGLU d_ff 16384, vocab
92553.  The InternViT vision encoder + MLP projector is a STUB per the
brief: ``prefix_embeds`` carries 64 precomputed patch embeddings
prepended to the token sequence.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    layer_pattern=("global",),
    activation="silu",
    gated_mlp=True,
    frontend="vision",
    num_prefix_tokens=64,
)
