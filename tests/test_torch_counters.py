"""The port's counter cells and sketch geometry against the JAX package.

Exact where the arithmetic is integer: the linear counter's `nfold`
(including past 2^24, where float32 stops being whole-number exact),
`pack_table` / `unpack_table`, spec geometry, key validation.

Log counters go through float32 expm1 / log1p / exp, and JAX's and
torch's CPU versions of those are not the same functions: on float32
inputs in [0, 16.5], expm1 disagrees on about 14% of inputs by up to 5
ulp, log1p on about 5% by up to 2 ulp, exp on about 10% by 1 ulp.  So
`decode` is held to 8 ulp, and `nfold` on a shared (state, n, u) grid
may land a different state on at most 1e-4 of entries, and then only one
state apart (the stochastic rounding threshold moved by an ulp).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import sketch as jsk
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk

LOG_COUNTERS = ["CMLS16", "CMLS8"]


def _pair(name):
    return getattr(jc, name), getattr(tc, name)


@pytest.mark.parametrize("name", ["CMS32", "CMLS16", "CMLS8"])
def test_counter_constants_match(name):
    j, t = _pair(name)
    assert (t.kind, t.base, t.bits) == (j.kind, j.base, j.bits)
    assert t.max_state == j.max_state
    assert t.cells_per_lane == j.cells_per_lane
    assert t.max_value == pytest.approx(j.max_value, rel=1e-12)
    assert np.dtype(j.dtype).itemsize * 8 == t.bits


def test_cms32_nfold_exact_including_past_2_24():
    j, t = _pair("CMS32")
    rng = np.random.default_rng(0)
    n_vals = np.array([0, 1, 2.5, 1e6, 2**24 - 1, 2**24 + 2, 3.0e9, 5.0e9,
                       0.25, 16777217.0], np.float32)
    states = np.concatenate([
        rng.integers(0, 2**32, 4000, dtype=np.uint64),
        [0, 1, 2**24, 2**31, 2**32 - 1, 2**32 - 2, 2**32 - 3_000_000_000]
    ]).astype(np.uint32)
    s = np.repeat(states, n_vals.size)
    n = np.tile(n_vals, states.size)
    u = rng.random(s.size, dtype=np.float32)
    want = np.asarray(j.nfold(jnp.asarray(s), jnp.asarray(n), jnp.asarray(u)))
    got = t.nfold(torch.from_numpy(s.astype(np.int64)), torch.from_numpy(n),
                  torch.from_numpy(u)).numpy()
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_decode_within_8_ulp(name):
    j, t = _pair(name)
    states = np.arange(t.max_state + 1, dtype=np.int64)
    want = np.asarray(j.decode(jnp.asarray(states.astype(np.uint32))))
    got = t.decode(torch.from_numpy(states)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=8)


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_point_mass_and_increase_prob_within_8_ulp(name):
    j, t = _pair(name)
    states = np.arange(0, t.max_state + 1, 7, dtype=np.int64)
    js = jnp.asarray(states.astype(np.float32))
    ts = torch.from_numpy(states)
    np.testing.assert_array_max_ulp(t.point_mass(ts).numpy(),
                                    np.asarray(j.point_mass(js)), maxulp=8)
    np.testing.assert_array_max_ulp(t.increase_prob(ts).numpy(),
                                    np.asarray(j.increase_prob(js)), maxulp=8)


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_nfold_at_u_zero_near_the_top_states_equals_jax(name):
    """A fixed grid where the log counter's nfold steps one state past the
    bound that tests/test_counters.py::test_property_nfold_monotone_and_
    bounded draws at random (CMLS8 nfold(246, 450, u=0) is 247, the bound
    246): states 240-255, n in {450, 1489, 1923, 10000}, u = 0.  The port
    lands exactly the JAX package's states there."""
    j, t = _pair(name)
    s = np.repeat(np.arange(240, 256), 4).astype(np.uint32)
    n = np.tile(np.array([450, 1489, 1923, 10000], np.float32), 16)
    u = np.zeros(s.size, np.float32)
    want = np.asarray(j.nfold(jnp.asarray(s), jnp.asarray(n), jnp.asarray(u)))
    got = t.nfold(torch.from_numpy(s.astype(np.int64)), torch.from_numpy(n),
                  torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    if name == "CMLS8":
        assert int(want[0]) == 241 and int(want[np.flatnonzero(
            (s == 246) & (n == 450))[0]]) == 247


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_nfold_differs_rarely_and_by_one_state(name):
    j, t = _pair(name)
    rng = np.random.default_rng(1)
    size = 1 << 20
    s = rng.integers(0, t.max_state + 1, size).astype(np.int64)
    n = np.where(rng.random(size) < 0.1, 0.0,
                 rng.integers(1, 5000, size)).astype(np.float32)
    u = rng.random(size, dtype=np.float32)
    want = np.asarray(j.nfold(jnp.asarray(s.astype(j.dtype)),
                              jnp.asarray(n), jnp.asarray(u))).astype(np.int64)
    got = t.nfold(torch.from_numpy(s), torch.from_numpy(n),
                  torch.from_numpy(u)).numpy()
    diff = got != want
    assert diff.mean() <= 1e-4, f"{int(diff.sum())} of {size} states differ"
    assert np.abs(got - want).max() <= 1
    # n == 0 never moves a cell, in either package
    zero = n == 0
    assert np.array_equal(got[zero], s[zero])


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_pack_unpack_exact(bits):
    rng = np.random.default_rng(bits)
    cpl = 32 // bits
    table = rng.integers(0, 2**bits, (3, 2, 64 * cpl),
                         dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jc.pack_table(jnp.asarray(table), bits))
    got = tc.pack_table(torch.from_numpy(table.astype(np.int64)), bits)
    assert got.dtype == torch.uint32
    assert np.array_equal(tc.to_numpy(got), want)
    back = np.asarray(jc.unpack_table(jnp.asarray(want), bits))
    assert np.array_equal(tc.unpack_table(got, bits).numpy(), back)
    assert np.array_equal(back, table)


@pytest.mark.parametrize("name", ["CMS32", "CMLS16", "CMLS8"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("budget", [1000, 32_768, 4_194_304])
def test_spec_geometry_matches(name, packed, budget):
    jcnt, tcnt = _pair(name)
    j = jsk.SketchSpec.from_memory(budget, depth=2, counter=jcnt,
                                   packed=packed)
    t = tsk.SketchSpec.from_memory(budget, depth=2, counter=tcnt,
                                   packed=packed)
    assert (t.width, t.depth, t.seed, t.packed) == (j.width, j.depth,
                                                    j.seed, j.packed)
    assert t.cells_per_lane == j.cells_per_lane
    assert t.storage_width == j.storage_width
    assert t.memory_bytes == j.memory_bytes
    sk_t = tsk.init(t, device="cpu")
    assert tc.to_numpy(sk_t.table).dtype == np.dtype(j.storage_dtype)


@pytest.mark.parametrize("keys", [
    np.array([1, 2, 3], np.int64), np.array([0, 2**32 - 1], np.uint64),
    np.array([[5, 6], [7, 8]], np.int32), np.array([], np.int64)])
def test_as_uint32_keys_matches(keys):
    assert np.array_equal(tsk.as_uint32_keys(keys), jsk.as_uint32_keys(keys))


@pytest.mark.parametrize("bad", [np.array([1.5]), np.array([-1]),
                                 np.array([2**32], np.int64)])
def test_as_uint32_keys_rejects_like_the_reference(bad):
    with pytest.raises((TypeError, ValueError)) as want:
        jsk.as_uint32_keys(bad)
    with pytest.raises(want.type):
        tsk.as_uint32_keys(bad)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.uint32])
def test_storage_helpers_round_trip(dtype):
    bits = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32}[dtype]
    vals = torch.tensor([0, 1, 2**bits - 1, 2**(bits - 1)], dtype=torch.int64)
    stored = tc.from_i64(vals, dtype)
    assert stored.dtype == dtype
    assert torch.equal(tc.to_i64(stored), vals)
    assert np.array_equal(tc.to_numpy(stored), vals.numpy())
    again = tc.from_numpy(tc.to_numpy(stored), "cpu")
    assert again.dtype == dtype and torch.equal(tc.to_i64(again), vals)
