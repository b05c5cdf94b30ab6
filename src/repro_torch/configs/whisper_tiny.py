"""whisper-tiny — encoder-decoder audio backbone (decoder implemented).

[arXiv:2212.04356] Robust Speech Recognition via Large-Scale Weak
Supervision.  Tiny: 4 layers, d_model 384, 6 heads (MHA: kv=6),
d_ff 1536, vocab 51865.  The mel-spectrogram + conv frontend is a STUB
per the brief: ``enc_out`` carries precomputed frame embeddings
(enc_len 1500); the decoder cross-attends to them.  RoPE replaces
learned absolute positions (TPU-backbone adaptation, DESIGN.md).
"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    layer_pattern=("global",),
    activation="gelu",
    gated_mlp=False,
    enc_dec=True,
    enc_len=1500,
    frontend="audio",
)
