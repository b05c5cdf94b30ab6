"""Adam, SGD and a cosine schedule over a model's parameter list (port of
``repro.train.optim``).

Plain functions in the JAX package's arithmetic order,
``p - lr * (m·s1) / (sqrt(v·s2) + eps)`` with ``s1 = 1 / (1 - b1^t)`` and
``s2 = 1 / (1 - b2^t)`` as float32 scalars; ``torch.optim.Adam`` orders
and rounds these differently.  Unlike the JAX package, the parameters,
the moments and the step are updated in place (no second copy of the
model).

The step is a 0-d int32 tensor on the parameters' device, as in the JAX
package, so a step never reads it on the host and can run inside a
captured CUDA graph.  The bias corrections come from a table indexed by
it: ``s1`` and ``s2`` for every step, computed once on the host in
float32 with the C library's ``powf`` (which XLA's CPU ``pow`` calls, so
the scales are the JAX package's bit for bit) up to the first step where
both round to 1.0, which every later step keeps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AdamState:
    step: torch.Tensor  # 0-d int32, on the parameters' device
    mu: list
    nu: list


def adam_init(params) -> AdamState:
    """Zero float32 moments and step for every parameter (a list, or an
    ``nn.Module``), on the parameters' device."""
    params = list(params.parameters()) if hasattr(params, "parameters") else list(params)
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
    dev = params[0].device if params else None
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros(),
                     nu=zeros())


_SCALES: dict = {}
_MAX_STEPS = 1 << 22


def _powf():
    """The C library's float32 ``powf``: XLA's CPU ``pow`` calls it, so it
    rounds as the JAX package's ``b ** t`` does (numpy's vectorized power
    does not: at ``b1 = 0.9`` it differs at step 4, at ``b2 = 0.999`` at
    264 of the first 20,000 steps)."""
    import ctypes
    import ctypes.util

    powf = ctypes.CDLL(ctypes.util.find_library("m")).powf
    powf.restype, powf.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return powf


def bias_scales(b1: float, b2: float, device) -> torch.Tensor:
    """``(T + 1, 2)`` float32 ``[s1, s2]`` of steps ``0 .. T`` on ``device``,
    where ``T`` is the first step at which both are 1.0 (row 0 unused; betas
    whose corrections take more than 2**22 steps raise ``ValueError``).
    ``s = 1 / (1 - b^t)`` in float32 with ``b^t`` from ``powf``, as the JAX
    package computes it; computed and uploaded once per ``(b1, b2,
    device)``."""
    device = torch.device(device)
    key = (float(b1), float(b2), device)
    table = _SCALES.get(key)
    if table is None:
        powf, one = _powf(), np.float32(1.0)
        f1, f2 = float(np.float32(b1)), float(np.float32(b2))
        rows = [(one, one)]
        while len(rows) < 2 or rows[-1] != (one, one):
            if len(rows) > _MAX_STEPS:
                raise ValueError(f"Adam betas {b1}, {b2}: the bias corrections do not "
                                 f"reach 1.0 within {_MAX_STEPS} steps")
            t = float(len(rows))
            rows.append((one / (one - np.float32(powf(f1, t))),
                         one / (one - np.float32(powf(f2, t)))))
        with torch.inference_mode(False):
            table = torch.from_numpy(np.asarray(rows, np.float32)).to(device)
        if type(table) is torch.Tensor:  # not a fake tensor of a trace
            _SCALES[key] = table
    return table


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
    """One Adam step: updates ``params``, the moments and the step in place
    (no host read: the bias corrections are a device lookup by the step),
    returns the state."""
    params = list(params.parameters()) if hasattr(params, "parameters") else list(params)
    table = bias_scales(b1, b2, state.step.device)
    if hasattr(state.step, "device_mesh"):  # a DTensor step (the dry-run's traces)
        from torch.distributed.tensor import DTensor

        table = DTensor.from_local(table, state.step.device_mesh, state.step.placements,
                                   run_check=False)
    state.step.add_(1)
    # a 1-d index: a 0-d one would be read on the host as a Python int
    row = state.step.clamp(max=table.shape[0] - 1).long().reshape(1)
    s1, s2 = table.index_select(0, row)[0].unbind()
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        g = g.to(m.dtype)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        u = (m * s1) / (torch.sqrt(v * s2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(u.dtype)
        p.copy_((p.to(u.dtype) - lr * u).to(p.dtype))
    return state


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
