"""Step-function factories for the LM pool (port of ``repro.launch.steps``).

``make_train_step``   — next-token CE + MoE aux loss + Adam update.
``make_prefill_step`` — inference forward over the full prompt.
``make_serve_step``   — ONE new token against a KV/SSM cache.

Each is a function of (model, [opt_state | state], batch).  The train
step runs autograd and then ``adam_update``, which updates the model
and the moments in place; the serving steps run under
``torch.inference_mode()``.  As the JAX launcher jits them, the train
step is one program (``make_train_step(...).program(model)``, a
:class:`repro_torch.engine.compiled.CompiledFunction` keyed by the
batch's shapes, the parameters and moments its state), and the serve
step the decode program of
:func:`repro_torch.models.transformer.decode_step`: each one captured
CUDA graph a key on a card, writing its state in place (the state passed
in is the state returned).  The CPU and a step under a registered mesh
(the dry-run's fake tensors) run the same bodies eagerly.  The forward
draws no random numbers, so remat keeps no RNG state
(``preserve_rng_state=False``), which a capture could not read.
"""
from __future__ import annotations

import weakref
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer import decode_step, forward_prefill, modules
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import LM, _unembed, forward_hidden
from repro_torch.models.transformer.modules import model_dim
from repro_torch.train.optim import adam_update


class _VocabParallelCE(torch.autograd.Function):
    """Sum over rows of ``logsumexp(logits) - logits[y]`` for logits split
    over the vocabulary across a process group (Megatron's vocab-parallel
    cross-entropy), on this rank's local shard: ``amax``, the exp-sum and
    the label's logit are each all-reduced over ``group``, one value a
    row, and the backward is the local softmax minus the one-hot."""

    @staticmethod
    def forward(ctx, logits, y, v_off: int, group):
        from torch.distributed import _functional_collectives as funcol

        Vl = logits.shape[-1]
        m = funcol.all_reduce(torch.amax(logits, dim=-1), "max", group)
        e = torch.exp(logits - m[..., None])
        se = funcol.all_reduce(torch.sum(e, dim=-1), "sum", group)
        hit = (y >= v_off) & (y < v_off + Vl)
        idx = torch.clamp(y.long() - v_off, 0, Vl - 1)
        ll = torch.where(hit, torch.gather(logits, -1, idx[..., None])[..., 0], 0.0)
        ll = funcol.all_reduce(ll, "sum", group)
        ctx.save_for_backward(e, se, idx, hit)
        return torch.sum(torch.log(se) + m - ll)

    @staticmethod
    def backward(ctx, g):
        e, se, idx, hit = ctx.saved_tensors
        p = e / se[..., None]
        p = p.scatter_add(-1, idx[..., None], -hit[..., None].to(p.dtype))
        return g * p, None, None, None


def _ce_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum(logsumexp(logits) - logits[y])`` over the rows.  Under a
    registered mesh (the dry-run), logits split over the vocabulary on the
    model dim would make DTensor all-gather them (``logsumexp``) and
    allocate a replicated gradient (``gather``'s backward); there the sum
    runs as :class:`_VocabParallelCE` on the local shards, and comes back
    as a DTensor partial over the batch dims.  Logits split over the batch
    dims only take the plain sum on each device's rows, partial likewise."""
    md = model_dim()
    if md is not None:
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh, mi = md
        if isinstance(logits, DTensor) and all(
                pl.dim < logits.ndim - 1 for pl in logits.placements if isinstance(pl, Shard)):
            # rows split over the batch dims, the vocabulary whole: each
            # device sums its own rows, so the logits' gradient keeps their
            # layout (``gather``'s backward on the DTensor would allocate it
            # replicated, the global batch's logits on every device)
            y = y.redistribute(mesh, logits.placements)
            local = _ce_sum(logits.to_local(), y.to_local())
            return DTensor.from_local(
                local, mesh, [Partial() if isinstance(pl, Shard) else pl
                              for pl in logits.placements], run_check=False)
        if isinstance(logits, DTensor) and logits.placements[mi] == Shard(logits.ndim - 1):
            batch = [Replicate() if i == mi else pl for i, pl in enumerate(logits.placements)]
            y = y.redistribute(mesh, [Shard(0) if isinstance(pl, Shard) else pl
                                      for pl in batch])
            v_off = mesh.get_local_rank("model") * logits.to_local().shape[-1]
            local = _VocabParallelCE.apply(logits.to_local(), y.to_local(), v_off,
                                           mesh.get_group("model"))
            return DTensor.from_local(
                local, mesh, [Replicate() if i == mi else
                              Partial() if isinstance(pl, Shard) else pl
                              for i, pl in enumerate(logits.placements)], run_check=False)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(logz - ll)


def _chunked_ce(cfg: ArchConfig, model: LM, h: torch.Tensor, labels: torch.Tensor,
                chunk: int = 512) -> torch.Tensor:
    """Next-token CE computed in sequence chunks.

    Materializing full (B, S, V) logits would take 8.4 GB at gemma2-2b's
    vocabulary, batch 4 and S 2,048; chunking caps the live logits at
    (B, chunk, V).  Each chunk is checkpointed (the port's
    ``jax.checkpoint``), so the backward recomputes its logits too.  The
    sum runs in the reference's order: the full chunks, each a float32
    scalar added to the running total, then the remainder, then the
    division by ``B*S``.
    """
    B, S, d = h.shape
    c = min(chunk, S)
    n = S // c
    rem = S - n * c

    def chunk_loss(h_c, y_c):
        return _ce_sum(_unembed(model, cfg, h_c).float(), y_c)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        total = total + checkpoint(chunk_loss, h[:, i * c:(i + 1) * c],
                                   labels[:, i * c:(i + 1) * c], use_reentrant=False,
                                   preserve_rng_state=False)
    if rem:
        total = total + checkpoint(chunk_loss, h[:, n * c:], labels[:, n * c:],
                                   use_reentrant=False, preserve_rng_state=False)
    return total / (B * S)


def lm_loss(cfg: ArchConfig, model: LM, batch, ce_chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE over text positions (+ MoE load-balance aux), a
    0-d tensor on the model's device."""
    h, aux = forward_hidden(
        model,
        cfg,
        batch["tokens"],
        batch.get("prefix_embeds"),
        batch.get("enc_out"),
    )
    h = h[:, cfg.num_prefix_tokens:, :]
    labels = torch.as_tensor(batch["labels"], device=h.device)
    ce = _chunked_ce(cfg, model, h, labels, chunk=ce_chunk)
    return ce + 0.01 * aux


def make_train_step(cfg: ArchConfig, lr: float = 1e-3) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss": loss})``: the loss and every parameter's gradient (zeros for
    a parameter the loss does not reach, as ``jax.grad`` gives), then one
    Adam step in place.  The loss is the 0-d device tensor of the
    parameters before the step; nothing waits on the host.

    The work is ``train_step.program(model)``, one program a model keyed
    by the batch's names and shapes, with the parameters and ``opt_state``
    passed by reference: a captured CUDA graph a key and state on a card
    with no registered mesh (the first call of each the eager warm-up),
    the same body eagerly otherwise; its ``fn(params, opt_state, batch)``
    is that body, run as it is.  ``batch`` holds tensors on the model's
    device.  A capture needs every earlier autograd graph over the
    parameters gone (a loss kept from an eager step holds one, made on
    another stream): otherwise it raises ``CaptureError``."""
    programs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def program(model: LM):
        from repro_torch.engine.compiled import CompiledFunction  # import cycle guard

        if model not in programs:
            ref = weakref.ref(model)  # the table must not keep the model alive

            def body(params: list, opt_state, batch: dict) -> torch.Tensor:
                loss = lm_loss(cfg, ref(), batch)
                grads = torch.autograd.grad(loss, params, allow_unused=True,
                                            materialize_grads=True)
                adam_update(params, grads, opt_state, lr=lr)
                return loss.detach()

            capture = model.embed.device.type == "cuda" and modules._LOGICAL_MESH is None
            programs[model] = CompiledFunction("lm.train_step", body, capture=capture,
                                               state_args=(0, 1))
        return programs[model]

    def train_step(model, opt_state, batch):
        key = tuple((k, tuple(v.shape)) for k, v in batch.items())
        loss = program(model)(key, list(model.parameters()), opt_state, batch)
        return model, opt_state, {"loss": loss}

    train_step.program = program
    return train_step


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
        return decode_step(model, cfg, state, token)

    return serve_step
