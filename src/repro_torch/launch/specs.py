"""Input, parameter and state specs per (architecture x input shape); port
of ``repro.launch.specs``.

The assigned input-shape grid:

    train_4k      seq  4,096  global_batch 256   train_step
    prefill_32k   seq 32,768  global_batch  32   prefill_step
    decode_32k    seq 32,768  global_batch 128   serve_step (1 token)
    long_500k     seq 524,288 global_batch   1   serve_step (1 token)

``long_500k`` is only generated for sub-quadratic-capable archs (SSM /
hybrid / native sliding-window); pure full-attention archs skip it.
Audio/VLM frontends appear as precomputed embedding specs.

Where the reference returns ``jax.ShapeDtypeStruct``s, the port returns
tensors on ``torch.device("meta")``: a shape and a dtype, no storage.
The meta device is not an entry-point device (``resolve_device`` takes
CUDA and the CPU only), so the model and state are built here without it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import LM, _decode_state, _init_params
from repro_torch.train.optim import AdamState

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs that may run long_500k (sub-quadratic or native sliding-window)
LONG_CONTEXT_OK = {"mamba2-2.7b", "hymba-1.5b", "gemma2-2b", "gemma3-27b"}


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.name.replace("-smoke", "") not in LONG_CONTEXT_OK:
        return False, "full-attention stack; long-context decode skipped (DESIGN.md §5)"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, spec: ShapeSpec) -> dict:
    """Meta tensors of the inputs of the step named by ``spec.kind``."""
    B, S = spec.global_batch, spec.seq_len
    dt = cfg.torch_dtype
    if spec.kind in ("train", "prefill"):
        s_text = S - cfg.num_prefix_tokens
        batch = {"tokens": _spec((B, s_text), torch.int32)}
        if spec.kind == "train":
            batch["labels"] = _spec((B, s_text), torch.int32)
        if cfg.num_prefix_tokens:
            batch["prefix_embeds"] = _spec((B, cfg.num_prefix_tokens, cfg.d_model), dt)
        if cfg.enc_dec:
            batch["enc_out"] = _spec((B, cfg.enc_len, cfg.d_model), dt)
        return batch
    # decode: one token + pre-sized caches
    return {"token": _spec((B, 1), torch.int32)}


def params_specs(cfg: ArchConfig) -> LM:
    """The :class:`LM` of ``cfg`` with every parameter on the meta device:
    ``init_lm``'s structure with no allocation.  No weight is drawn; only
    ``init_lm``'s key splits and an SSD layer's few ``A_log`` uniforms
    (one a head) are computed, on the host."""
    return LM(cfg, _init_params(cfg, 0, META))


def opt_specs(params_s) -> AdamState:
    """``adam_init``'s state for ``params_s`` (an :class:`LM` or a list of
    parameters) as meta tensors: float32 moments for floating parameters."""
    params = list(params_s.parameters()) if hasattr(params_s, "parameters") else list(params_s)

    def mom(p):
        dt = torch.float32 if p.dtype.is_floating_point else p.dtype
        return _spec(p.shape, dt)

    return AdamState(step=0, mu=[mom(p) for p in params], nu=[mom(p) for p in params])


def decode_state_specs(cfg: ArchConfig, spec: ShapeSpec) -> dict:
    """``init_decode_state(cfg, batch, seq_len)`` as meta tensors."""
    return _decode_state(cfg, spec.global_batch, spec.seq_len, META)
