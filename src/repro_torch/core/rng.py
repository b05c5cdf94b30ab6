"""Stateless, counter-based randomness for samplers (port of ``repro.core.rng``).

A sampled plan is integer state, and it has to match the JAX package bit
for bit.  Two things make that hard, and this module handles both:

* uint32 arithmetic.  PyTorch has no usable uint32 multiply, so every
  hash runs in int64 and is masked back to 32 bits after each multiply
  and before each shift.  Multiplies are split into 16-bit halves so no
  intermediate leaves the int64 range on either device.
* ``norm.cdf(norm.ppf(u))``.  The LABOR variate is compared with
  thresholds like ``k / d``, and NS ranks a row's edge variates, so a
  last-bit difference in a variate can flip an accept decision or a
  pick.  ``torch.special.ndtr``/``ndtri`` differ from what XLA computes
  on the CPU.  This module therefore evaluates the
  same float32 algorithms that XLA's CPU backend emits for the JAX
  reference: ``jax.scipy.special.ndtri`` after XLA's algebraic
  simplification, the CHLO expansion of ``erfc``, XLA's rational
  ``erf``, and XLA's Cephes-style ``exp``/``log``, with the fused
  multiply-adds that XLA's CPU code generator forms (emulated exactly
  through float64).  Only IEEE-exact operations (+, -, *, /, float64
  sqrt, floor, bit casts) are used, so the CPU and a CUDA card give the same
  bits as each other.

Smoothed interpolation between two seeds (A.7) is bit-equal as well, to
the form ``plan_at`` and the jitted train step compile, where the state
``(z1, z2, c)`` is a traced value: XLA forms ``fma(cos, n1, sin * n2)``
and calls the C library's ``cosf``/``sinf`` on ``c * (pi/2)``, so this
module does the same (``tests/test_torch_plan.py`` pins c = 0 and c > 0
states, and every ``c = i/kappa`` for kappa up to 64).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

_MASK32 = 0xFFFFFFFF


def _f(x: float) -> float:
    """A python float holding the float32 value nearest ``x``."""
    return float(np.float32(x))


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 ``x`` in [0, 2**32), overflow-free."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _u32(x) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return x.to(torch.int64) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche on uint32 values held in int64."""
    x = _u32(x)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_u32(ids, seed, salt=0) -> torch.Tensor:
    """Deterministic uint32 hash (as int64) of integer ids under (seed, salt)."""
    ids = _u32(ids)
    seed = _u32(torch.as_tensor(seed, device=ids.device))
    salt = _u32(torch.as_tensor(salt, device=ids.device))
    h = _mix(ids ^ _mul32(seed, 0x9E3779B9))
    return _mix(h ^ _mul32(salt, 0x85EBCA6B))


def hash_pair_u32(a, b, seed, salt=0) -> torch.Tensor:
    """Hash of an id pair (edge ``(t, s)``); order-sensitive."""
    ha = hash_u32(a, seed, salt)
    return _mix(ha ^ _mix(_u32(b) ^ 0xDEADBEEF))


def uniform_from_u32(h: torch.Tensor) -> torch.Tensor:
    """uint32 (int64) -> float32 in the open interval (0, 1)."""
    return (h.to(torch.float32) + 0.5) * _f(1.0 / 4294967296.0)


def uniform_from_ids(ids, seed, salt: int = 0) -> torch.Tensor:
    return uniform_from_u32(hash_u32(ids, seed, salt))


# --------------------------------------------------------------------------
# float32 special functions, as XLA's CPU backend evaluates them
# --------------------------------------------------------------------------
def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (the product is exact in
    float64; the float64 sum then rounds once more, which differs from a
    true FMA only on exact float32 midpoints)."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).to(torch.float32)


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    y = torch.full_like(x, _f(coefs[0]))
    for c in coefs[1:]:
        y = _fma(y, x, _f(c))
    return y


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (``torch.sqrt`` on the CPU is not:
    its vectorized float32 path is off by one ulp on ~0.6% of inputs)."""
    return x.double().sqrt().to(torch.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _from_bits(i: torch.Tensor) -> torch.Tensor:
    return i.to(torch.int32).view(torch.float32)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp (Cephes range reduction + degree-5 polynomial)."""
    x = x.clamp(_f(-87.8), _f(88.8))
    fx = torch.floor(_fma(x, _f(1.44269502), 0.5)).clamp(-127.0, 127.0)
    r = _fma(fx, -_f(0.693359375), x)
    r = _fma(fx, _f(2.12194440e-4), r)
    y = _horner([1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                 4.1665795894e-2, 1.6666665459e-1, 0.5], r)
    y = _fma(y, r * r, r) + 1.0
    scale = _from_bits((fx.to(torch.int32) + 127) << 23)
    return y * scale


_LOG_P = [0x3d9021bb, 0xbdebd1b8, 0x3def251a, 0xbdfe5d4f, 0x3e11e9bf,
          0xbe2aae50, 0x3e4cceac, 0xbe7ffffc, 0x3eaaaaaa]
_LOG_P = [float(np.array([h], np.uint32).view(np.float32)[0]) for h in _LOG_P]


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log for finite x > 0 (Cephes, Estrin-split)."""
    x = torch.clamp(x, min=1.1754943508222875e-38)
    b = _bits(x)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    m = _from_bits((b & -2139095041) | 1056964608)      # mantissa in [0.5, 1)
    small = m < _f(0.7071067690849304)
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    p = _LOG_P
    x2 = m * m
    x3 = x2 * m
    a = _fma(_fma(m, p[0], p[1]), m, p[2])
    bb = _fma(_fma(m, p[3], p[4]), m, p[5])
    c = _fma(_fma(m, p[6], p[7]), m, p[8])
    t = _fma(_fma(a, x3, bb), x3, c)
    y = _fma(t, x3, e * _f(-2.12194440e-4))
    r = _fma(x2, -0.5, m) + y
    return _fma(e, 0.693359375, r)


_ERF_A = [0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084]
_ERF_B = [-1.1791602954361697e-7, 0.000023547966471313185,
          0.0010179625278914885, 0.014070470171167667, 0.11098505178285362,
          0.49746925110067538, 1.0]


def _erf(x: torch.Tensor) -> torch.Tensor:
    """float32 erf (rational approximation; used for |x| < 1 only)."""
    k = _f(3.832506856900711)
    x = x.clamp(-k, k)
    x2 = x * x
    return (x * _horner(_ERF_A, x2)) / _horner(_ERF_B, x2)


_ERFC_SMALL = [7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129,
               0.112835854, -0.37612626, 1.12837911]
_ERFC_MID = [0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469,
             -0.494451523, 0.340488, -0.274112701, 0.563825965]
_ERFC_BIG = [-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
             0.42184633, -0.282076746, 0.564189494]


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF, float32 (``jax.scipy.special.ndtr``)."""
    x = x.to(torch.float32)
    half_sqrt_2 = _f(0.5 * math.sqrt(2.0))
    w = x * half_sqrt_2
    z = w.abs()
    x2 = w * w
    # erfc(z), CHLO expansion: 1 - erf for z < 1, else exp(-z^2)/z * P(1/z^2)
    erfc_lt1 = _fma(-z, _horner(_ERFC_SMALL, x2), 1.0)
    r = 1.0 / x2
    poly = torch.where(z < 2.0, _horner(_ERFC_MID, r), _horner(_ERFC_BIG, r))
    erfc_ge1 = (_exp(-x2) * (1.0 / z)) * poly
    erfc_ge1 = torch.where(-x2 < _f(-88.7228394), torch.zeros_like(x2), erfc_ge1)
    erfc = torch.where(z < 1.0, erfc_lt1, erfc_ge1)
    y = torch.where(
        z < half_sqrt_2, _erf(w) + 1.0,
        torch.where(w > 0.0, 2.0 - erfc, erfc),
    )
    return y * 0.5


_NDTRI_P0 = [-5.99633501014107895267E1, 9.80010754185999661536E1,
             -5.66762857469070293439E1, 1.39312609387279679503E1,
             -1.23916583867381258016E0]
_NDTRI_Q0 = [1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
             8.63602421390890590575E1, -2.25462687854119370527E2,
             2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0]
_NDTRI_P1 = [4.05544892305962419923E0, 3.15251094599893866154E1,
             5.71628192246421288162E1, 4.40805073893200834700E1,
             1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
             -8.57456785154685413611E-4]
_NDTRI_Q1 = [1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
             4.13172038254672030440E1, 1.50425385692907503408E1,
             2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4]
_NDTRI_P2 = [3.23774891776946035970E0, 6.91522889068984211695E0,
             3.93881025292474443415E0, 1.33303460815807542389E0,
             2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6,
             6.23974539184983293730E-9]
_NDTRI_Q2 = [1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
             1.37702099489081330271E0, 2.16236993594496635890E-1,
             1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9]


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """Inverse standard normal CDF, float32 (``jax.scipy.special.ndtri``)."""
    p = p.to(torch.float32)
    hi = p > _f(-np.expm1(-2.0))
    mcp = torch.where(hi, 1.0 - p, p)
    s = torch.where(mcp == 0.0, torch.full_like(mcp, 0.5), mcp)
    # p > exp(-2): x/sqrt(2pi) = w + w**3 P0(w**2)/Q0(w**2)
    w = s - 0.5
    ww = w * w
    ratio = _horner(_NDTRI_P0, ww) / _horner(_NDTRI_Q0, ww)
    x_big = _fma(w * ww, ratio, w) * -_f(np.sqrt(2.0 * np.pi))
    # p <= exp(-2): x = z - log(z)/z - P(1/z) / (Q(1/z) z)
    m2log = _log(s) * -2.0
    z = _sqrt(m2log)
    first = z - (_log(m2log) * 0.5) / z
    iz = 1.0 / z
    x_tiny = first - _horner(_NDTRI_P2, iz) / (_horner(_NDTRI_Q2, iz) * z)
    x_small = first - _horner(_NDTRI_P1, iz) / (_horner(_NDTRI_Q1, iz) * z)
    x = torch.where(
        s > _f(np.exp(-2.0)), x_big, torch.where(z >= 8.0, x_tiny, x_small)
    )
    x = torch.where(hi, x, -x)
    x = torch.where(p == 1.0, torch.full_like(x, math.inf), x)
    return torch.where(p == 0.0, torch.full_like(x, -math.inf), x)


@lru_cache(maxsize=None)
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        getattr(lib, name).argtypes = [ctypes.c_float]
        getattr(lib, name).restype = ctypes.c_float
    return lib


def _cos_sin_half_pi(c: float) -> tuple[float, float]:
    """float32 ``(cos(c pi/2), sin(c pi/2))`` as XLA's CPU code computes them
    for a traced ``c``: one float32 product ``c * f32(pi/2)``, then the C
    library's ``cosf``/``sinf`` (neither ``torch.cos`` nor a correctly
    rounded cosine gives the same bits)."""
    ang = float(np.float32(c) * np.float32(math.pi / 2))
    lib = _libm()
    return _f(lib.cosf(ang)), _f(lib.sinf(ang))


def normal_from_ids(ids, seed, salt: int = 0) -> torch.Tensor:
    """Standard normal via inverse-CDF of the hashed uniform."""
    return ndtri(uniform_from_ids(ids, seed, salt))


def normal_from_pairs(a, b, seed, salt: int = 0) -> torch.Tensor:
    return ndtri(uniform_from_u32(hash_pair_u32(a, b, seed, salt)))


def _smoothed(c: float, n1: torch.Tensor, u2) -> torch.Tensor:
    """``ndtr(fma(cos(c pi/2), n1, sin(c pi/2) * ndtri(u2())))`` in float32, as
    XLA compiles it for a traced ``c``; ``u2()`` gives the second seed's
    uniforms.  At ``c == 0`` that is ``n1 + 0 * n2``: ``n1`` itself, except
    NaN where ``n2`` is infinite (a hash at or above ``2**32 - 128`` rounds to
    the uniform 1.0), so there only the uniform is computed, not ``ndtri``."""
    if c == 0.0:
        return ndtr(torch.where(u2() >= 1.0, math.nan, n1))
    cos, sin = _cos_sin_half_pi(c)
    return ndtr(_fma(n1, cos, ndtri(u2()) * sin))


@dataclass(frozen=True)
class RNGState:
    """Two seeds + interpolation coefficient (python scalars).

    ``c == 0`` reduces exactly to independent sampling.
    """

    z1: int  # uint32
    z2: int  # uint32
    c: float  # float32 value in [0, 1)

    def vertex_uniform(self, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
        """r_t ~ U(0,1), smoothly drifting with step (LABOR variates); see
        :func:`_smoothed`.  Profiler span: ``rng.vertex_uniform``."""
        with record_function("rng.vertex_uniform"):
            return _smoothed(self.c, normal_from_ids(ids, self.z1, salt),
                             lambda: uniform_from_ids(ids, self.z2, salt))

    def edge_uniform(self, t: torch.Tensor, s: torch.Tensor, salt: int = 0) -> torch.Tensor:
        """r_ts ~ U(0,1) per edge ``(t, s)`` (NS variates), smoothly drifting;
        the same float32 operations as :meth:`vertex_uniform`.  Profiler
        span: ``rng.edge_uniform``."""
        with record_function("rng.edge_uniform"):
            return _smoothed(self.c, normal_from_pairs(t, s, self.z1, salt),
                             lambda: uniform_from_u32(hash_pair_u32(t, s, self.z2, salt)))

    def fold(self, salt: int) -> int:
        """A uint32 sub-seed (random-walk streams): ``z1 * 0x9E3779B9 +
        salt * 0x85EBCA6B``, wrapping."""
        return (self.z1 * 0x9E3779B9 + (salt & _MASK32) * 0x85EBCA6B) & _MASK32


@dataclass(frozen=True)
class DependentRNG:
    """Seed schedule implementing smoothed dependent minibatching (A.7).

    Seeds for window ``w = step // kappa`` are ``base + w`` (z1) and
    ``base + w + 1`` (z2); ``c = (step % kappa) / kappa``.
    ``kappa = None`` is infinite dependency (static neighborhoods).
    """

    base_seed: int
    kappa: int | None = 1
    step: int = 0

    def at_step(self, step: int) -> "DependentRNG":
        return DependentRNG(self.base_seed, self.kappa, step)

    def state_at(self, step: int) -> RNGState:
        base = self.base_seed & _MASK32
        if self.kappa is None:
            return RNGState(base, base, 0.0)
        step = int(step)
        window, i = step // self.kappa, step % self.kappa
        c = float(np.float32(np.float32(i) / np.float32(self.kappa)))
        z1 = (base + window) & _MASK32
        return RNGState(z1, (z1 + 1) & _MASK32, c)

    @property
    def state(self) -> RNGState:
        return self.state_at(self.step)

    def vertex_uniform(self, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
        return self.state.vertex_uniform(ids, salt)

    def edge_uniform(self, t: torch.Tensor, s: torch.Tensor, salt: int = 0) -> torch.Tensor:
        return self.state.edge_uniform(t, s, salt)

    def fold(self, salt: int) -> int:
        return self.state.fold(salt)
