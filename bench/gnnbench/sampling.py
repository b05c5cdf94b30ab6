"""The sampling arithmetic of the plain reference: a frozen copy.

LABOR-0 keeps an edge ``t -> s`` when the vertex variate ``r_t`` is at
most ``min(1, fanout / deg(s))``.  ``r_t`` is ``ndtr(ndtri(u))`` of a
hashed uniform ``u``, evaluated in float32 with the same operations the
system under test uses, so that a variate within a few ulps of a
threshold decides alike on both sides: the uint32 hashes in int64, and
XLA's CPU float32 ``ndtri``/``ndtr`` (Cephes ``exp``/``log``, the CHLO
``erfc``, fused multiply-adds emulated through float64).  The seed draw
(a hash-keyed permutation of each pool row) and the hash partition's
owner are copied alike.

This file is a copy kept with the benchmark so that a later change of
the system cannot change the yardstick; it imports nothing of the system.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
INVALID = int(np.iinfo(np.int32).max)  # the padding id of the plans compared


def f32(x: float) -> float:
    """A python float holding the float32 value nearest ``x``."""
    return float(np.float32(x))


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _u32(x) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return x.to(torch.int64) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = _u32(x)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def mix_int(x: int) -> int:
    x &= MASK32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & MASK32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def hash_u32(ids, seed: int, salt) -> torch.Tensor:
    """uint32 hash (in int64) of ``ids`` under a python ``seed`` and a
    python or tensor ``salt`` that broadcasts."""
    h = _mix(_u32(ids) ^ ((int(seed) & MASK32) * GOLDEN & MASK32))
    if isinstance(salt, torch.Tensor):
        s = _mul32(_u32(salt), 0x85EBCA6B)
    else:
        s = ((int(salt) & MASK32) * 0x85EBCA6B) & MASK32
    return _mix(h ^ s)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    return (h.to(torch.float32) + 0.5) * f32(1.0 / 4294967296.0)


def _fma(a, b, c) -> torch.Tensor:
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).to(torch.float32)


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    y = torch.full_like(x, f32(coefs[0]))
    for c in coefs[1:]:
        y = _fma(y, x, f32(c))
    return y


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return x.double().sqrt().to(torch.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _from_bits(i: torch.Tensor) -> torch.Tensor:
    return i.to(torch.int32).view(torch.float32)


def _exp(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(f32(-87.8), f32(88.8))
    fx = torch.floor(_fma(x, f32(1.44269502), 0.5)).clamp(-127.0, 127.0)
    r = _fma(fx, -f32(0.693359375), x)
    r = _fma(fx, f32(2.12194440e-4), r)
    y = _horner([1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                 4.1665795894e-2, 1.6666665459e-1, 0.5], r)
    y = _fma(y, r * r, r) + 1.0
    scale = _from_bits((fx.to(torch.int32) + 127) << 23)
    return y * scale


_LOG_P = [float(np.array([h], np.uint32).view(np.float32)[0]) for h in
          (0x3d9021bb, 0xbdebd1b8, 0x3def251a, 0xbdfe5d4f, 0x3e11e9bf,
           0xbe2aae50, 0x3e4cceac, 0xbe7ffffc, 0x3eaaaaaa)]


def _log(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, min=1.1754943508222875e-38)
    b = _bits(x)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    m = _from_bits((b & -2139095041) | 1056964608)
    small = m < f32(0.7071067690849304)
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    p = _LOG_P
    x2 = m * m
    x3 = x2 * m
    a = _fma(_fma(m, p[0], p[1]), m, p[2])
    bb = _fma(_fma(m, p[3], p[4]), m, p[5])
    c = _fma(_fma(m, p[6], p[7]), m, p[8])
    t = _fma(_fma(a, x3, bb), x3, c)
    y = _fma(t, x3, e * f32(-2.12194440e-4))
    r = _fma(x2, -0.5, m) + y
    return _fma(e, 0.693359375, r)


_ERF_A = [0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084]
_ERF_B = [-1.1791602954361697e-7, 0.000023547966471313185,
          0.0010179625278914885, 0.014070470171167667, 0.11098505178285362,
          0.49746925110067538, 1.0]
_ERFC_SMALL = [7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129,
               0.112835854, -0.37612626, 1.12837911]
_ERFC_MID = [0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469,
             -0.494451523, 0.340488, -0.274112701, 0.563825965]
_ERFC_BIG = [-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
             0.42184633, -0.282076746, 0.564189494]


def _erf(x: torch.Tensor) -> torch.Tensor:
    k = f32(3.832506856900711)
    x = x.clamp(-k, k)
    x2 = x * x
    return (x * _horner(_ERF_A, x2)) / _horner(_ERF_B, x2)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    half_sqrt_2 = f32(0.5 * math.sqrt(2.0))
    w = x * half_sqrt_2
    z = w.abs()
    x2 = w * w
    erfc_lt1 = _fma(-z, _horner(_ERFC_SMALL, x2), 1.0)
    r = 1.0 / x2
    poly = torch.where(z < 2.0, _horner(_ERFC_MID, r), _horner(_ERFC_BIG, r))
    erfc_ge1 = (_exp(-x2) * (1.0 / z)) * poly
    erfc_ge1 = torch.where(-x2 < f32(-88.7228394), torch.zeros_like(x2), erfc_ge1)
    erfc = torch.where(z < 1.0, erfc_lt1, erfc_ge1)
    y = torch.where(z < half_sqrt_2, _erf(w) + 1.0,
                    torch.where(w > 0.0, 2.0 - erfc, erfc))
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
    p = p.to(torch.float32)
    hi = p > f32(-np.expm1(-2.0))
    mcp = torch.where(hi, 1.0 - p, p)
    s = torch.where(mcp == 0.0, torch.full_like(mcp, 0.5), mcp)
    w = s - 0.5
    ww = w * w
    ratio = _horner(_NDTRI_P0, ww) / _horner(_NDTRI_Q0, ww)
    x_big = _fma(w * ww, ratio, w) * -f32(np.sqrt(2.0 * np.pi))
    m2log = _log(s) * -2.0
    z = _sqrt(m2log)
    first = z - (_log(m2log) * 0.5) / z
    iz = 1.0 / z
    x_tiny = first - _horner(_NDTRI_P2, iz) / (_horner(_NDTRI_Q2, iz) * z)
    x_small = first - _horner(_NDTRI_P1, iz) / (_horner(_NDTRI_Q1, iz) * z)
    x = torch.where(s > f32(np.exp(-2.0)), x_big, torch.where(z >= 8.0, x_tiny, x_small))
    x = torch.where(hi, x, -x)
    x = torch.where(p == 1.0, torch.full_like(x, math.inf), x)
    return torch.where(p == 0.0, torch.full_like(x, -math.inf), x)


def cos_sin_half_pi(c: float) -> tuple[float, float]:
    """float32 ``cos`` and ``sin`` of ``c * f32(pi/2)`` from the C library."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        getattr(lib, name).argtypes = [ctypes.c_float]
        getattr(lib, name).restype = ctypes.c_float
    ang = float(np.float32(c) * np.float32(math.pi / 2))
    return f32(lib.cosf(ang)), f32(lib.sinf(ang))


def rng_state(seed: int, kappa: int, step: int) -> tuple[int, int, float]:
    """``(z1, z2, c)`` of the smoothed schedule (A.7) at ``step``."""
    base = seed & MASK32
    window, i = divmod(int(step), kappa)
    c = float(np.float32(np.float32(i) / np.float32(kappa)))
    z1 = (base + window) & MASK32
    return z1, (z1 + 1) & MASK32, c


def vertex_uniform(ids: torch.Tensor, state: tuple, salt: int) -> torch.Tensor:
    """``r_t`` of LABOR for every id under ``state = (z1, z2, c)``:
    ``ndtr(fma(n1, cos, n2 * sin))`` of the two seeds' normals."""
    z1, z2, c = state
    cos, sin = cos_sin_half_pi(c)
    n1 = ndtri(_uniform(hash_u32(ids, z1, salt)))
    n2 = ndtri(_uniform(hash_u32(ids, z2, salt)))
    return ndtr(_fma(n1, cos, n2 * sin))


def labor0_accept(nbr: torch.Tensor, valid: torch.Tensor, state: tuple, layer: int,
                  fanout: int) -> torch.Tensor:
    """Which slots of a neighbor table ``(n, D)`` LABOR-0 keeps at ``layer``."""
    deg = valid.sum(dim=1).to(torch.float32)
    r = vertex_uniform(nbr, state, salt=layer)
    thresh = torch.clamp(fanout / torch.clamp(deg, min=1.0), max=1.0)
    return (r <= thresh[:, None]) & valid


def draw_key(step: int, seed: int) -> int:
    return mix_int((step & MASK32) ^ ((seed * GOLDEN) & MASK32))


def permute_rows(rows: torch.Tensor, key: int) -> torch.Tensor:
    """Each row of an INVALID-padded pool table in hash-key order (stable)."""
    salt = torch.arange(rows.shape[0], dtype=torch.int64, device=rows.device)[:, None]
    k = hash_u32(rows, key, salt)
    k = torch.where(rows != INVALID, k.clamp(max=0xFFFFFFFE), 0xFFFFFFFF)
    order = torch.sort(k, dim=1, stable=True).indices
    return torch.gather(rows, 1, order)


def hash_owner_table(num_vertices: int, num_parts: int, device) -> torch.Tensor:
    """The hash partition's owner of every vertex, ``((v * 0x9E3779B97F4A7C15)
    mod 2**64 >> 33) mod num_parts``, worked out on the host in uint64."""
    v = np.arange(num_vertices, dtype=np.uint64)
    h = (v * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
    return torch.from_numpy((h % np.uint64(num_parts)).astype(np.int64)).to(device)
