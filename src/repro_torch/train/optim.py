"""Adam, SGD and a cosine schedule over a model's parameter list (port of
``repro.train.optim``).

Plain functions in the JAX package's arithmetic order,
``p - lr * (m·s1) / (sqrt(v·s2) + eps)`` with ``s1 = 1 / (1 - b1^t)`` and
``s2 = 1 / (1 - b2^t)`` as float32 scalars; ``torch.optim.Adam`` orders
and rounds these differently.  Unlike the JAX package, the parameters
and moments are updated in place (no second copy of the model).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AdamState:
    step: int
    mu: list
    nu: list


def adam_init(params) -> AdamState:
    """Zero float32 moments for every parameter (a list, or an ``nn.Module``)."""
    params = list(params.parameters()) if hasattr(params, "parameters") else list(params)
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return AdamState(step=0, mu=zeros(), nu=zeros())


@torch.no_grad()
def adam_update(
    params,
    grads,
    state: AdamState,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> AdamState:
    """One Adam step: updates ``params`` and the moments in place, returns
    the state with its step advanced."""
    params = list(params.parameters()) if hasattr(params, "parameters") else list(params)
    step = state.step + 1
    t = np.float32(step)
    one = np.float32(1.0)
    s1 = float(one / (one - np.power(np.float32(b1), t)))
    s2 = float(one / (one - np.power(np.float32(b2), t)))
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        g = g.to(m.dtype)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        u = (m * s1) / (torch.sqrt(v * s2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(u.dtype)
        p.copy_((p.to(u.dtype) - lr * u).to(p.dtype))
    return AdamState(step=step, mu=state.mu, nu=state.nu)


@torch.no_grad()
def sgd_update(params, grads, lr: float = 1e-2, momentum_state=None, momentum: float = 0.9):
    """``p - lr * g``, or with a momentum buffer ``m = momentum * m + g``,
    ``p - lr * m``; updates ``params`` (and the buffers) in place and
    returns the buffers (None without momentum)."""
    params = list(params.parameters()) if hasattr(params, "parameters") else list(params)
    if momentum_state is None:
        for p, g in zip(params, grads):
            p.copy_(p - lr * g)
        return None
    for p, g, m in zip(params, grads, momentum_state):
        m.copy_(momentum * m + g)
        p.copy_(p - lr * m)
    return momentum_state


def cosine_lr(step, base_lr: float, warmup: int, total: int, min_frac: float = 0.1) -> float:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine decay
    to ``min_frac * base_lr`` at ``total``, in float32 as the JAX package
    computes it."""
    f = np.float32
    step = f(step)
    if step < warmup:
        return float(f(base_lr) * step / f(max(warmup, 1)))
    prog = np.clip((step - f(warmup)) / f(max(total - warmup, 1)), f(0.0), f(1.0))
    cos = f(base_lr) * (f(min_frac) + f(1 - min_frac) * f(0.5) * (f(1) + np.cos(f(np.pi) * prog)))
    return float(cos)
