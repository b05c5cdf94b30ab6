"""The pieces of ``jax.random`` that ``init_gnn`` draws weights with.

A port of JAX's default generator, ``threefry2x32`` in its partitionable
form (``jax_threefry_partitionable``, the default since JAX 0.5): a key
is two uint32 words; :func:`split` and :func:`random_bits` hash the
flat index of every output element, as a 64-bit counter split into a
(high, low) pair of words, under the key; 32-bit random bits are the XOR
of the hash's two output words.  The uint32 arithmetic runs in int64
tensors masked to 32 bits, as :mod:`repro_torch.core.rng` does, so the
draw gives the same bits on any device; callers run it on the CPU.

:func:`uniform` builds float32 values as ``jax.random.uniform`` does: the
top 23 random bits ORed into the bits of 1.0, minus 1, then
``u * (maxval - minval) + minval`` as ONE fused multiply-add, clamped
below at ``minval``.  XLA's CPU backend contracts that multiply-add (as it
does those of :mod:`repro_torch.core.rng`, ROADMAP C1): the unfused form,
a rounding after the multiply and another after the add, differs from
the JAX draw in the last bit of some values at every shape tried, the
fused form at none (``tests/test_torch_threefry.py`` holds it bit for
bit against the installed JAX).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.rng import _fma

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds of the counter words ``(x0, x1)`` under
    ``key`` (two words); uint32 values held in int64, returned likewise."""
    ks = (int(key[0]), int(key[1]))
    ks = (*ks, ks[0] ^ ks[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def _counters(shape) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat index of every element of ``shape`` as (high, low) words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    return idx >> 32, idx & _MASK32


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s two words, ``(0, seed)``."""
    if isinstance(seed, (bool, np.bool_)) or not isinstance(seed, (int, np.integer)) or not (
            0 <= seed < 2**31):
        raise ValueError(f"prng_key: want a non-negative int32 seed, got {seed!r}")
    return torch.tensor([0, int(seed)], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` new keys."""
    return torch.stack(threefry2x32(key, *_counters((num,))), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values."""
    b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, _fma(u, hi - lo, lo))
