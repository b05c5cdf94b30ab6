"""gemma2-2b — local/global alternating attention with logit softcaps.

[arXiv:2408.00118] Gemma 2.  2B: 26 layers, d_model 2304, 8 query heads
(head_dim 256) / 4 KV heads, GeGLU d_ff 9216, vocab 256000, sliding
window 4096 on alternating layers, attn softcap 50, final logit
softcap 30.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    activation="gelu",
    gated_mlp=True,
)
