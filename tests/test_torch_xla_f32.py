"""The port's replica of XLA's CPU float32 math (`core/xla_f32.py`)
against `jnp` on the CPU, bit for bit.

  * `expm1`, `exp` (and `tanh`, which `expm1` takes below 0.5) at
    s * log b for every state s of CMLS16 and CMLS8: the decode and point
    mass of every re-encode;
  * 10^6 seeded float32 samples of each function's domain in the
    re-encode path (log1p over v * (b - 1) for v up to twice each
    format's max_value, the most a merged sum of two decodes reaches, and
    the float32 bands just above max_value and just below twice it;
    exp / expm1 / tanh / log over their ranges), with 0, the
    branch thresholds and odd array lengths (XLA's scalar tail loop);
  * `fma` against a float64 reference, ties included, and each function
    on a CUDA tensor equal to the CPU (`test_torch_cuda.py` runs it on the
    card).

`tools/xla_f32_check.py` walks every float32 of log1p's domain.
Tolerance: none, every result is compared bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import CMLS8, CMLS16
from repro_torch.core import xla_f32

N = 1_000_000


def _same_bits(name, x):
    x = np.array(x, np.float32)  # a writable copy for torch.from_numpy
    got = getattr(xla_f32, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jnp, name)(jnp.asarray(x)))
    bad = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
    assert bad.size == 0, (name, x[bad[:5]], got[bad[:5]], want[bad[:5]])


@pytest.mark.parametrize("counter", [CMLS16, CMLS8], ids=["CMLS16", "CMLS8"])
@pytest.mark.parametrize("name", ["expm1", "exp"])
def test_every_state_argument(name, counter):
    s = jnp.arange(counter.max_state + 1, dtype=jnp.float32)
    arg = np.asarray(s * jnp.float32(math.log(counter.base)))
    _same_bits(name, arg)
    _same_bits("tanh", np.asarray(jnp.asarray(arg) * 0.5))


def _samples(seed, lo, hi, n=N):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("counter", [CMLS16, CMLS8], ids=["CMLS16", "CMLS8"])
def test_log1p_reencode_domain(counter):
    """v * (b - 1) for v spread over [0, 2 * max_value] (log-uniform, so
    every binade is sampled; a merged sum of two decodes reaches twice
    max_value), the 1,000 float32 values above max_value and below twice
    it, and near the sqrt(2) - 1 branch point."""
    rng = np.random.default_rng(7)
    top = math.log(2.0 * counter.max_value)
    v = np.exp(rng.uniform(-12.0, top, N - 2003)).astype(np.float32)
    sat = np.float32(counter.max_value).view(np.int32)
    dbl = np.float32(2.0 * counter.max_value).view(np.int32)
    band = np.concatenate([sat + np.arange(500, dtype=np.int32),
                           dbl - np.arange(500, dtype=np.int32)])
    v = np.concatenate([v, band.view(np.float32)])
    x = np.asarray(jnp.asarray(v) * jnp.float32(counter.base - 1.0))
    edge = np.float32(0.41421357) + np.arange(-500, 500, dtype=np.float32) \
        * np.spacing(np.float32(0.41421357))
    _same_bits("log1p", np.concatenate([x, edge, [0.0, 1.0, 1e-30]]))


@pytest.mark.parametrize("name,lo,hi,seed", [
    ("exp", -30.0, 25.0, 1), ("expm1", -3.0, 25.0, 2),
    ("tanh", -12.0, 12.0, 3), ("log", 1e-6, 1e8, 4)])
def test_sampled_domains(name, lo, hi, seed):
    x = _samples(seed, lo, hi, N - 7)
    near = {"expm1": 0.5, "tanh": 0.0004, "exp": 0.0, "log": 0.70710677}
    t = np.float32(near[name])
    x = np.concatenate([x, [0.0, t, -t, np.nextafter(t, np.float32(1)),
                            np.nextafter(t, np.float32(-1)), 1.0, 2.0]])
    _same_bits(name, x.astype(np.float32))


def test_fma_rounds_once():
    """fma(a, b, c) == float32(a * b + c) computed exactly (float64 holds
    a * b exactly; the exact sum is checked by fractions on the cases
    where one rounding of the float64 sum would double-round)."""
    from fractions import Fraction
    rng = np.random.default_rng(11)
    a = rng.standard_normal(200_000).astype(np.float32)
    b = rng.standard_normal(200_000).astype(np.float32)
    c = rng.standard_normal(200_000).astype(np.float32)
    # ties of the float64 sum: c = -(a*b) rounded plus a half-ulp nudge
    a[:6] = [1.0, 1.0 + 2**-23, 3.0, 1.0, -1.5, 1.0 + 2**-22]
    b[:6] = [1.0 + 2**-23, 1.0 + 2**-23, 1.0 / 3, 2**-30, 1.0 + 2**-23,
             1.0 - 2**-24]
    c[:6] = [2**-24, -1.0, 2**-26, 1.0, 2**-25, -(2**-48)]
    def fma(sl):
        return xla_f32.fma(torch.from_numpy(a[sl]), torch.from_numpy(b[sl]),
                           torch.from_numpy(c[sl])).numpy()

    def exact(i):
        x = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(x))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                         int(np.float32(y).view(np.int32))
                                         & 1))

    got = fma(slice(None))  # with the ties: the round-to-odd fix-up
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    for i in list(np.flatnonzero(got != naive)) + list(range(6)):
        assert got[i] == exact(i), (i, a[i], b[i], c[i], got[i])
    rest = fma(slice(6, None))  # no tie: one float64 rounding suffices
    np.testing.assert_array_equal(rest, got[6:])
    for i in range(6, 2006):
        assert rest[i - 6] == exact(i), (i, a[i], b[i], c[i])
