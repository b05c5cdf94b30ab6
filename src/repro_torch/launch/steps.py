"""Step-function factories for the LM pool's serving path (port of the
serving half of ``repro.launch.steps``).

``make_prefill_step`` — inference forward over the full prompt.
``make_serve_step``   — ONE new token against a KV/SSM cache.

Both are functions of (model, [state], batch) that run under
``torch.inference_mode()``.  The training half (``lm_loss``,
``_chunked_ce``, ``make_train_step``) is not ported yet (ROADMAP A14).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models.transformer import forward_decode, forward_prefill
from repro_torch.models.transformer.config import ArchConfig


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(model, batch):
        logits, _ = forward_prefill(
            model,
            cfg,
            batch["tokens"],
            batch.get("prefix_embeds"),
            batch.get("enc_out"),
        )
        return logits  # (B, V) last-position logits

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(model, state, token):
        logits, state = forward_decode(model, cfg, state, token)
        return logits, state

    return serve_step
