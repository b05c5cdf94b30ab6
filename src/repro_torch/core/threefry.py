"""The pieces of ``jax.random`` that ``init_gnn`` and ``init_lm`` draw
weights with.

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

from repro_torch.core.rng import _f, _fma, _horner, _log, _sqrt

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 1 << 26  # counters a chunk of :func:`normal`


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


def _counters(shape, start: int = 0, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat index (from ``start``) of every element of ``shape`` as
    (high, low) words."""
    idx = torch.arange(start, start + math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
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


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, _fma(u, hi - lo, lo))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _uniform_from_bits(random_bits(key, shape), minval, maxval)


_LOG1P_NUM = [4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1]
_LOG1P_DEN = [1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1]
_ERFINV_LT5 = [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941]
_ERFINV_GE5 = [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682]


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA's CPU backend emits it: ``log(1 + x)``,
    except a Cephes rational approximation for ``|x| < sqrt(2) - 1``."""
    x2 = x * x
    ratio = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + _fma(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < _f(0.41421356237309504880), small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it (M. Giles'
    single-precision polynomial); ``+-inf`` at ``+-1``."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lt, _f(_ERFINV_LT5[0]), _f(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, ww, torch.where(lt, _f(a), _f(b)))
    return x * torch.where(x.abs() == 1.0, math.inf, p)


def normal(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``, drawn on ``device`` in
    chunks of at most :data:`CHUNK` elements."""
    shape = tuple(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    if out.is_meta:  # the shape only (launch.specs): nothing to draw
        return out.reshape(shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    sqrt2 = _f(math.sqrt(2.0))
    for start in range(0, n, CHUNK):
        count = min(CHUNK, n - start)
        b0, b1 = threefry2x32(key, *_counters((count,), start, device=out.device))
        out[start:start + count] = erf_inv(_uniform_from_bits(b0 ^ b1, lo, 1.0)) * sqrt2
    return out.reshape(shape)
