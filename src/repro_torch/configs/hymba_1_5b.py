"""hymba-1.5b — hybrid-head: parallel attention + Mamba heads per layer.

[arXiv:2411.13676] Hymba: 32 layers, d_model 1600, 25 query heads /
5 KV heads (head_dim 64), SwiGLU d_ff 5504, vocab 32001, SSM state 16.
Attention is sliding-window (1024) in all but 3 full-attention layers
(first / middle / last), fused with the SSD path by averaging — the
published "parallel hybrid head" topology.
"""
from repro_torch.models.transformer.config import ArchConfig

# Pattern period 16 (scan-friendly): full-attention layers land at
# depths 0 and 16 (paper places 3 at first/middle/last; we keep
# first/middle and window the last — documented approximation).
_pattern = ("hybrid_global",) + ("hybrid",) * 15

CONFIG = ArchConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    layer_pattern=_pattern,
    window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=256,
    activation="silu",
    gated_mlp=True,
)
