"""nemotron-4-15b — dense GQA decoder with squared-ReLU MLP.

[arXiv:2402.16819] Nemotron-4 15B: 32 layers, d_model 6144, 48 query
heads / 8 KV heads (GQA), d_ff 24576 with squared-ReLU (non-gated),
vocab 256000.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    layer_pattern=("global",),
    activation="relu2",
    gated_mlp=False,
    tie_embeddings=False,
)
