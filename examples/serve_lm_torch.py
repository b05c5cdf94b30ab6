"""Serve a small LM with batched requests (decode path demo) on the PyTorch
port.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch gemma2-2b] [--device cpu]

The port's twin of ``serve_lm.py``, at its configuration: the REDUCED
variant of an assigned architecture prefills the whole prompt batch with
``prefill_decode`` (it steps the per-token decode step, so the caches
come out bit-identical to stepping ``serve_step`` over the prompt) and
then greedy-decodes new tokens with the KV/SSM cache ``serve_step``.  As
the reference jits both, both run the decode program: on the card one
captured CUDA graph, replayed for every prompt position and every new
token (the state updated in place); the tokens stay on the device until
the end.  Runs on the CUDA card unless ``--device cpu`` (eager there).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.transformer import init_decode_state, init_lm, prefill_decode


def serve_lm(arch: str = "gemma2-2b", batch: int = 4, prompt_len: int = 16,
             new_tokens: int = 24, device=None, model=None) -> dict:
    """Serve at ``serve_lm.py``'s configuration (``model``: weights to use
    in place of ``init_lm(cfg, seed=0)``); returns the greedy tokens
    ``(batch, new_tokens)``, the prompts and the seconds taken."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = init_lm(cfg, seed=0, device=dev) if model is None else model
    rng = np.random.default_rng(0)
    B, S0 = batch, prompt_len
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S0)), dtype=torch.int32,
                              device=dev)

    max_len = S0 + new_tokens
    state = init_decode_state(cfg, B, max_len, device=dev)
    serve = make_serve_step(cfg)

    # prefill the whole prompt (caches bit-identical to stepping the decoder
    # token by token), then sample greedily
    t0 = time.perf_counter()
    logits, state = prefill_decode(model, cfg, state, prompts)
    out = []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for _ in range(new_tokens):
        out.append(tok)
        logits, state = serve(model, state, tok)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    gen = torch.cat(out, 1).cpu().numpy()  # the one read of the tokens
    dt = time.perf_counter() - t0
    total = B * (S0 + new_tokens)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.name}  batch={B}  decoded {gen.shape[1]} tokens/seq")
    print(f"tokens: {gen[0][:12].tolist()} ...")
    print(f"{total / dt:.1f} tok/s on {where} (reduced config)")
    return dict(tokens=gen, prompts=prompts.cpu().numpy(), seconds=dt)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    serve_lm(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
             new_tokens=args.new_tokens, device=args.device)
