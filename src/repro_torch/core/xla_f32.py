"""float32 math as XLA's CPU backend compiles the reference's, bit for bit.

The reference's counter arithmetic rounds through `jnp.expm1`, `jnp.exp`
and `jnp.log1p`, which XLA's CPU backend lowers to its own polynomial
approximations (Cephes `expf` / `logf`, XLA's rational `tanh` and
`log1p`) with every single-use multiply feeding an add fused into one
FMA.  torch's float32 functions (glibc / SLEEF on the CPU, libdevice on
CUDA) round differently on about one state value in forty.  `exp`,
`expm1`, `tanh`, `log` and `log1p` here follow the same operation graph,
constant for constant, so they equal `jnp` on every input that
`tools/xla_f32_check.py` walks (every CMLS16 and CMLS8 state, every
float32 of `log1p`'s re-encode domain); a NaN's sign bit may differ.

The reference's paths do not all compile one graph.  Called op by op
(eagerly) `CounterSpec.decode` is `expm1(s * logb) / (b - 1)`, each op
rounded alone.  Under `jax.jit` (the kernels' interpret mode, the XLA
engines, `lax.scan`), XLA's algebraic simplifier turns a division by a
constant into a multiplication by its float32 reciprocal and
`a / exp(x)` into `a * exp(-x)`, and LLVM contracts each single-use
multiply into the add that consumes it.  The `morris_*` functions below
are that jitted graph, read from the dumped IR of the reference's
`jax.jit(CounterSpec.nfold)` and checked against its update, query and
window paths (`XLA_FLAGS=--xla_dump_to=DIR`; the `*.ir-with-opt.ll` and
`*cpu_after_optimizations.txt` files name every `fmul`, `fdiv` and
FMA).  `pow` is XLA's `**` of float32 operands: a call of the C
library's `powf`.

XLA's CPU also runs with denormals flushed to zero, inputs and results.
On the counter paths the one denormal that can arrive is an input weight
n, so `morris_nfold` flushes it (`flush`); the window weights and their
products with an estimate are flushed where they are made
(`stream/window.py`, the window reads).

They are plain torch elementwise ops and give the same bits on any
device: an FMA is computed exactly as a float64 product (exact for
float32 operands) plus a float64 sum, rounded to odd and then to
float32, which is one correctly rounded rounding (on the CPU the
round-to-odd step is skipped when no sum sits on a float32 tie, where
it changes nothing).  The CUDA kernels compute the same graph in
`kernels/csrc/xla_f32.cuh`, FMA for FMA.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
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


def log(u: torch.Tensor) -> torch.Tensor:
    """`jnp.log` of float32 u (Cephes logf on the mantissa in
    [sqrt(1/2), sqrt(2)) and the exponent e)."""
    t = torch.where(u > _c(_MIN_NORM, u), u, _c(_MIN_NORM, u))
    bits = t.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)
    mask = m < _c(_SQRTHF, u)
    e = ((bits >> 23) - 127).to(_F32) + 1.0 - mask.to(_F32)
    t = (m - 1.0) + torch.where(mask, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    y, y1, y2 = (_horner_fma(t, _LOG_P[i:i + 3]) for i in (0, 3, 6))
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * _c(_LN2_LO, u))
    r = fma(e, _LN2_HI, (t - x2 * 0.5) + y)
    # XLA's special cases, bit for bit: NaN as all-ones bits below 0
    bits = torch.where((u <= 0) | torch.isnan(u), -1, r.view(torch.int32))
    r = torch.where(u == math.inf, u, bits.view(_F32))
    return torch.where(u == 0, torch.full_like(u, -math.inf), r)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log1p` of float32 x: a rational approximation below
    sqrt(2) - 1, `log(x + 1)` above."""
    large = log(x + 1.0)
    x2 = x * x
    den = x + _c(_LOG1P_DEN[1], x)  # the first step: (0 * x + 1) * x + c
    for k in _LOG1P_DEN[2:]:
        den = fma(den, x, k)
    q = _horner_fma(x, _LOG1P_NUM) / den
    small = x + fma(x2, -0.5, (x * x2) * q)
    return torch.where(x.abs() < _c(_LOG1P_SMALL, x), small, large)


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


def morris_pm(s: torch.Tensor, logb: float) -> torch.Tensor:
    """exp(s * logb) of float32 states: b^s, the point mass."""
    return exp(s * _c(logb, s))


def morris_ep(s: torch.Tensor, logb: float) -> torch.Tensor:
    """exp(-(s * logb)) of float32 states: b^-s, the increase probability
    and (as a factor) the jitted graph's division by the point mass."""
    return exp(-(s * _c(logb, s)))


def morris_encode_floor(v: torch.Tensor, logb: float, bm1: float, em
                        ) -> torch.Tensor:
    """Jitted `encode_floor` of float32 v: floor(log1p(v * bm1) *
    f32(1 / logb)), less one where decode of it exceeds
    fma(max(v, 1), 1e-6, v).  `em(c)`: `morris_em` of integral c."""
    c = torch.floor(log1p(v * _c(bm1, v)) * _c(recip(logb), v))
    limit = fma(torch.clamp_min(v, 1.0), 1e-6, v)
    too_high = em(c) * _c(recip(bm1), v) > limit
    return torch.clamp_min(c - too_high.to(_F32), 0.0)


def morris_nfold(s: torch.Tensor, n: torch.Tensor, u: torch.Tensor,
                 logb: float, bm1: float, max_state: int, em, ep
                 ) -> torch.Tensor:
    """Jitted `nfold` of a log counter: float32 states s, weights n and
    uniforms u -> float32 new states.  `em(c)` / `ep(c)`: `morris_em` /
    `morris_ep` of integral c (a table gather or the functions)."""
    n = flush(n)
    rbm1 = recip(bm1)
    v2 = fma(em(s), rbm1, n)
    c2 = torch.maximum(morris_encode_floor(v2, logb, bm1, em), s)
    frac = fma(-em(c2), rbm1, v2) * ep(c2)
    new = torch.where(n > 0, c2 + (u < frac).to(_F32), s)
    return torch.clamp(new, 0.0, float(max_state))


@functools.lru_cache(maxsize=None)
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    f = libm.powf
    f.restype = ctypes.c_float
    f.argtypes = [ctypes.c_float, ctypes.c_float]
    return f


def _flush_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < np.float32(_MIN_NORM), x * np.float32(0), x)


def _powf_each(bases, y: float) -> np.ndarray:
    powf = _powf()
    y = float(np.float32(y))
    return _flush_np([powf(float(b), y) for b in _flush_np(bases)])


@functools.lru_cache(maxsize=1024)
def _pow_row(g: float, top: int) -> np.ndarray:
    powf = _powf()
    return _flush_np([powf(g, float(a)) for a in range(top)])


def pow(g: float, ages: np.ndarray) -> np.ndarray:
    """`jnp.float32(g) ** ages` for integral ages >= 0 (the window
    weights): XLA's CPU calls the C library's `powf` for a float32
    `power` (its IR holds `llvm.pow.f32`), and flushes a denormal result.
    Host numpy in and out; one `powf` per age below the largest, cached
    per g."""
    ages = np.asarray(ages)
    top = int(ages.max(initial=-1)) + 1
    return _pow_row(float(np.float32(g)), top)[ages.astype(np.int64)]


def pow_host(x: torch.Tensor, y: float) -> torch.Tensor:
    """`x ** y` of a float32 tensor and a float exponent as XLA's CPU runs
    it op by op (`powf`, denormals flushed), through the host: one
    `powf` per distinct value of x."""
    host = x.detach().to("cpu", torch.float32).numpy()
    uniq, inv = np.unique(host, return_inverse=True)
    out = _powf_each(uniq, y)[inv].reshape(host.shape)
    return torch.from_numpy(out).to(x.device)
