"""The LM pool's generic decoder (port of ``repro.models.transformer``)."""
from repro_torch.models.transformer.config import ArchConfig, active_param_count, param_count
from repro_torch.models.transformer.model import (
    LM,
    decode_program,
    decode_state_from_jax,
    decode_step,
    forward_decode,
    forward_hidden,
    forward_prefill,
    forward_train,
    init_decode_state,
    init_lm,
    lm_params_from_jax,
    lm_params_to_jax,
    prefill_decode,
)

__all__ = [
    "ArchConfig",
    "LM",
    "active_param_count",
    "decode_program",
    "decode_state_from_jax",
    "decode_step",
    "forward_decode",
    "forward_hidden",
    "forward_prefill",
    "forward_train",
    "init_decode_state",
    "init_lm",
    "lm_params_from_jax",
    "lm_params_to_jax",
    "param_count",
    "prefill_decode",
]
