"""float32 math of the sketch's counters, frozen for the benchmark.

A copy of the port's `core/xla_f32.py` as it stood when the benchmark was
defined (the functions the counter update, the decode and the window
reads use): XLA's CPU float32 graph of `exp`, `expm1`, `log`, `log1p`
and `tanh`, every FMA computed exactly as a float64 product plus a
float64 sum rounded to odd, then to float32.  The benchmark's reference
computes the sketch with it, so a change to the program's own copy
cannot move the yardstick.  Plain torch; imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_F32 = torch.float32
_MIN_NORM = 1.1754944e-38

# Cephes expf: range reduction by ln 2 in two parts, then a degree-5
# polynomial, as XLA emits it
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.442695
_LN2_HI, _LN2_LO = 0.6933594, -0.00021219444
_EXP_P = (0.00019875691, 0.0013981999, 0.008333452, 0.041665796,
          0.16666666, 0.5)

# XLA's rational tanh (the clamp is where float32 tanh rounds to 1)
_TANH_CLAMP = 7.9988117
_TANH_SMALL = 0.0004
_TANH_NUM = (-2.7607684e-16, 2.000188e-13, -8.604672e-11, 5.1222973e-08,
             1.48572235e-05, 0.00063726195, 0.0048935246)
_TANH_DEN = (1.1982584e-06, 0.00011853471, 0.0022684347, 0.004893525)

# Cephes logf
_SQRTHF = 0.70710677
_LOG_P = (0.070376836, -0.1151461, 0.116769984, -0.12420141, 0.14249323,
          -0.16668057, 0.20000714, -0.24999994, 0.3333333)

# XLA's log1p below sqrt(2) - 1: x - x^2/2 + x^3 * num(x) / den(x)
_LOG1P_SMALL = 0.41421357
_LOG1P_DEN = (1.0, 15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
              60.11866)
_LOG1P_NUM = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
              57.112965, 20.039553)

_CONSTS: dict = {}


def _c(x: float, like: torch.Tensor,
       dtype: torch.dtype = _F32) -> torch.Tensor:
    """Cached 0-dim constant float32(x) (or float64) on `like`'s device."""
    key = (x, dtype, str(like.device))
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.tensor(x, dtype=_F32).to(dtype).to(
            like.device)
    return c


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with ONE rounding (an FMA), on any device.

    The float64 product of two float32 values is exact; the float64 sum
    is made round-to-odd from its exact TwoSum error, and rounding a
    round-to-odd float64 to float32 is the correctly rounded result."""
    f64 = torch.float64
    a64 = a.to(f64)
    b64 = b.to(f64) if torch.is_tensor(b) else _c(b, a, f64)
    c64 = c.to(f64) if torch.is_tensor(c) else _c(c, a, f64)
    p = a64 * b64
    s = p + c64
    if s.device.type == "cpu":
        # only a float64 sum sitting on a float32 tie (the low 29 bits
        # 1 << 28) can round twice; where none does, one rounding is exact
        # (on the CPU the check costs no synchronize, and skipping the
        # fix-up takes about a quarter off log1p's and expm1's time)
        if not bool(((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000).any()):
            return s.to(_F32)
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = _c(math.inf, a, torch.float64)
    toward = torch.where(err > 0, inf, -inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(_F32)


def _horner_fma(x: torch.Tensor, coeffs) -> torch.Tensor:
    """((c0 x + c1) x + c2) ... with every step one FMA (XLA's Horner
    chains; fma's product commutes, so the operand order is free)."""
    p = fma(x, coeffs[0], coeffs[1])
    for k in coeffs[2:]:
        p = fma(p, x, k)
    return p


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2^n for float32 integral n in [-127, 127], built from its bits."""
    return ((n.to(torch.int32) + 127) << 23).view(_F32)


def exp(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp` of float32 x."""
    x = torch.clamp(x, _c(_EXP_LO, x), _c(_EXP_HI, x))
    fx = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(fx, -_LN2_HI, x)
    r = fma(fx, -_LN2_LO, r)
    p = _horner_fma(r, _EXP_P)
    y = fma(p, r * r, r) + 1.0
    return y * _pow2(fx)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """`jnp.tanh` of float32 x."""
    ax = x.abs()
    c = torch.clamp(x, _c(-_TANH_CLAMP, x), _c(_TANH_CLAMP, x))
    x2 = c * c
    num = c * _horner_fma(x2, _TANH_NUM)
    res = num / _horner_fma(x2, _TANH_DEN)
    res = torch.where(ax < _c(_TANH_SMALL, x), x, res)
    return torch.where(ax >= 20.0, torch.copysign(torch.ones_like(x), x),
                       res)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """`jnp.expm1` of float32 x: exp(x) - 1 above |x| = 0.5, else
    tanh(x / 2) * (exp(x) + 1)."""
    e = exp(x)
    h = x * 0.5
    small = tanh(h) * (e + 1.0)
    res = torch.where(x.abs() > 0.5, e - 1.0, small)
    return torch.where(h == 0, x, res)


# ---- the jitted counter graph (`CounterSpec`'s forms under jax.jit) ----

def recip(x: float) -> float:
    """float32(1) / float32(x) rounded to float32: the constant XLA folds
    a division by float32(x) into."""
    return float(np.float32(1.0) / np.float32(x))


def flush(x: torch.Tensor) -> torch.Tensor:
    """x with float32 denormals replaced by a zero of their sign, as XLA's
    CPU (flush-to-zero, denormals-are-zero) reads them."""
    return torch.where(x.abs() < _c(_MIN_NORM, x), x * 0.0, x)


def morris_em(s: torch.Tensor, logb: float) -> torch.Tensor:
    """expm1(s * logb) of float32 states: the decode's transcendental."""
    return expm1(s * _c(logb, s))


def morris_ep(s: torch.Tensor, logb: float) -> torch.Tensor:
    """exp(-(s * logb)) of float32 states: b^-s, the increase probability
    and (as a factor) the jitted graph's division by the point mass."""
    return exp(-(s * _c(logb, s)))
