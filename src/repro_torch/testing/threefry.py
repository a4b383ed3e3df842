"""A numpy copy of the counter-based random draws behind two fuzz corpora.

The JAX package's ``tall_thin`` and ``clustered`` fuzz corpora draw their
extents from a threefry key (``make_tall_thin_workload`` and
``make_clustered_workload`` of its ``core/intervals.py``), seeded from the
fuzzer's ``np.random.RandomState``.  To hand the port the same extents bit
for bit, this module computes the same draws on the host: the
Threefry-2x32 hash (20 rounds), key splitting and folding in the
partitionable counter layout, 32-bit random words, and from them
``uniform``, ``randint`` and ``normal`` in float32 and int32.

``normal`` is √2 · erfinv(u) with the float32 erfinv polynomial (Giles),
whose ``log1p`` is the Cephes rational form below √2 − 1 and a Cephes
``log`` of 1 + x above, each fused multiply-add where the compiled
reference fuses one.  Every fused multiply-add here is rounded once
(:func:`_fma`), so the results are the reference's to the bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.errors import ValidationError

Key = Tuple[np.uint32, np.uint32]
_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _hash(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 of the counter pairs (x1, x2) under key (k1, k2)."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x1 = x1.astype(np.uint32) + ks[0]
        x2 = x2.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x1 = x1 + x2
                x2 = (x2 << _U32(r)) | (x2 >> _U32(32 - r))
                x2 = x1 ^ x2
            x1 = x1 + ks[(i + 1) % 3]
            x2 = x2 + ks[(i + 2) % 3] + _U32(i + 1)
    return x1, x2


def key(seed: int) -> Key:
    """The key of a 32-bit integer seed."""
    return _U32(0), _U32(int(seed) & 0xFFFFFFFF)


def _counted(k: Key, n: int):
    return _hash(k[0], k[1], np.zeros(n, np.uint32),
                 np.arange(n, dtype=np.uint32))


def split(k: Key, num: int = 2):
    b1, b2 = _counted(k, num)
    return [(b1[i], b2[i]) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    b1, b2 = _hash(k[0], k[1], np.zeros(1, np.uint32),
                   np.asarray([data], np.uint32))
    return b1[0], b2[0]


def random_bits(k: Key, shape) -> np.ndarray:
    b1, b2 = _counted(k, int(np.prod(shape)))
    return (b1 ^ b2).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """float32 a·b + c rounded once: the product is exact in float64, the
    sum is made round-to-odd there (two-sum error term), so its rounding
    to float32 is the correctly rounded fused result."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = s.view(np.int64) & 1
    fix = (err != 0) & (odd == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def uniform(k: Key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    lo, hi = _F32(minval), _F32(maxval)
    bits = random_bits(k, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - _F32(1)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def randint(k: Key, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 in [minval, maxval) from two words a value."""
    if maxval <= minval:
        raise ValidationError(f"randint needs maxval > minval, got "
                              f"[{minval}, {maxval})")
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval)
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + (lower % span)) % span
    return np.int32(minval) + off.astype(np.int32)


_LOG_P = tuple(_F32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _log(x: np.ndarray) -> np.ndarray:
    """Cephes float32 log (positive finite inputs)."""
    x = np.maximum(x.astype(np.float32), np.finfo(np.float32).tiny)
    m, e = np.frexp(x)
    m, e = m.astype(np.float32), e.astype(np.float32)
    small = m < _F32(0.707106781186547524)
    x = (m - _F32(1)) + np.where(small, m, _F32(0))
    e = e - small.astype(np.float32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(p[0], x, p[1])
    y1 = _fma(p[3], x, p[4])
    y2 = _fma(p[6], x, p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    x = _fma(_F32(-0.5), x2, x)
    x = x + y
    return _fma(_F32(0.693359375), e, x)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: np.ndarray) -> np.ndarray:
    def poly(coeffs):
        out = np.zeros_like(x)
        for c in coeffs:
            out = _fma(out, x, _F32(c))
        return out

    x2 = x * x
    small = (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + _fma(_F32(-0.5), x2, small)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    _log(x + _F32(1)))


_ERFINV_W5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_WBIG = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = -_log1p(-(x * x))
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(np.float32)
    p = np.where(lt, _F32(_ERFINV_W5[0]), _F32(_ERFINV_WBIG[0]))
    for a, b in zip(_ERFINV_W5[1:], _ERFINV_WBIG[1:]):
        p = _fma(p, w, np.where(lt, _F32(a), _F32(b)))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1, x * _F32(np.inf), p * x) \
            .astype(np.float32)


def normal(k: Key, shape) -> np.ndarray:
    """Standard normal float32 draws."""
    lo = np.nextafter(_F32(-1), _F32(0))
    return (_F32(np.sqrt(2)) * _erfinv(uniform(k, shape, lo, 1.0))) \
        .astype(np.float32)
