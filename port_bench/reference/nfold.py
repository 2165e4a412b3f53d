"""The counter update's float32 graph in NumPy, for the reference's loop.

The same graph as `reference/f32.py` (the jitted `nfold` of a log
counter: XLA's Cephes `log`, its rational `log1p`, every FMA one
rounding) on NumPy arrays, so a CHUNK of the conservative update costs a
few hundred small NumPy operations instead of torch dispatches.  An FMA
is the float64 product of two float32 values (exact) plus a float64
sum, rounded to odd from its exact error, then to float32: one correct
rounding.  The decode tables (`expm1(s logb)`, `exp(-(s logb))` of every
state) come from `reference/f32.py`.
"""
from __future__ import annotations

import numpy as np

from reference import f32 as tf

F32, F64 = np.float32, np.float64
_MIN_NORM = F32(tf._MIN_NORM)


def fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding: a float64 sum can round twice
    only where it sits on a float32 tie (its low 29 bits 1 << 28), and
    only there is it made round-to-odd first."""
    a64 = np.asarray(a, F32).astype(F64)
    b64 = np.asarray(b, F32).astype(F64)
    c64 = np.asarray(c, F32).astype(F64)
    p = a64 * b64
    s = p + c64
    if not ((s.view(np.int64) & 0x1FFFFFFF) == 0x10000000).any():
        return s.astype(F32)
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(np.int64) & 1) == 0
    fix = (err != 0) & even
    if fix.any():
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                     s)
    return s.astype(F32)


def _horner(x, coeffs) -> np.ndarray:
    p = fma(x, F32(coeffs[0]), F32(coeffs[1]))
    for k in coeffs[2:]:
        p = fma(p, x, F32(k))
    return p


def log(u: np.ndarray) -> np.ndarray:
    t = np.where(u > _MIN_NORM, u, _MIN_NORM).astype(F32)
    bits = t.view(np.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).astype(np.int32).view(F32)
    mask = m < F32(tf._SQRTHF)
    e = (((bits >> 23) - 127).astype(F32) + F32(1.0)) - mask.astype(F32)
    t = (m - F32(1.0)) + np.where(mask, m, F32(0.0))
    x2 = t * t
    x3 = x2 * t
    y, y1, y2 = (_horner(t, tf._LOG_P[i:i + 3]) for i in (0, 3, 6))
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * F32(tf._LN2_LO))
    r = fma(e, F32(tf._LN2_HI), (t - x2 * F32(0.5)) + y)
    bits = np.where((u <= 0) | np.isnan(u), np.int32(-1), r.view(np.int32))
    r = np.where(u == np.inf, u, bits.astype(np.int32).view(F32))
    return np.where(u == 0, F32(-np.inf), r).astype(F32)


def log1p(x: np.ndarray) -> np.ndarray:
    large = log(x + F32(1.0))
    x2 = x * x
    den = x + F32(tf._LOG1P_DEN[1])
    for k in tf._LOG1P_DEN[2:]:
        den = fma(den, x, F32(k))
    q = _horner(x, tf._LOG1P_NUM) / den
    small = x + fma(x2, F32(-0.5), (x * x2) * q)
    return np.where(np.abs(x) < F32(tf._LOG1P_SMALL), small, large)


def flush(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < _MIN_NORM, x * F32(0.0), x)


def encode_floor(v, logb: float, bm1: float, em) -> np.ndarray:
    c = np.floor(log1p(v * F32(bm1)) * F32(tf.recip(logb)))
    limit = fma(np.maximum(v, F32(1.0)), F32(1e-6), v)
    too_high = em(c) * F32(tf.recip(bm1)) > limit
    return np.maximum(c - too_high.astype(F32), F32(0.0))


def nfold(s, n, u, logb: float, bm1: float, max_state: int, em, ep
          ) -> np.ndarray:
    """float32 states s, weights n, uniforms u -> float32 new states."""
    n = flush(n.astype(F32))
    rbm1 = F32(tf.recip(bm1))
    v2 = fma(em(s), rbm1, n)
    c2 = np.maximum(encode_floor(v2, logb, bm1, em), s)
    frac = fma(-em(c2), rbm1, v2) * ep(c2)
    new = np.where(n > 0, c2 + (u < frac).astype(F32), s)
    return np.clip(new, F32(0.0), F32(max_state))
