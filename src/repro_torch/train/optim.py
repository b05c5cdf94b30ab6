"""Adam over a model's parameter list (port of ``repro.train.optim``).

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
