"""mamba2-2.7b — attention-free SSD state-space model.

[arXiv:2405.21060] Transformers are SSMs (Mamba-2), 2.7B config:
64 layers, d_model 2560, d_state 128, attention-free, no MLP (d_ff=0),
GPT-NeoX vocab 50280.  d_inner = 2*d = 5120, 80 SSD heads of dim 64.
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)
