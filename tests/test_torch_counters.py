"""The port's counter cells and sketch geometry against the JAX package.

Exact everywhere.  Integer arithmetic: the linear counter's `nfold`
(including past 2^24, where float32 stops being whole-number exact),
`pack_table` / `unpack_table`, spec geometry, key validation.  Log
counters: the reference's float32 math is XLA's CPU backend, and its
jitted and op-by-op (eager) graphs round differently (a division by a
constant becomes a multiplication by its reciprocal under jit, single-use
multiplies fuse into FMAs).  The port has both (`core/xla_f32.py`):
`decode`, `encode_floor`, `nfold` against `jax.jit` of the reference's
functions, `decode_eager` and `nfold(eager=True)` against the eager
calls, `point_mass` and `increase_prob` against both, every state of
CMLS16 and CMLS8, bit for bit.
"""
import jax
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


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_decode_equals_jax(name):
    """Every state: `decode` equals `jax.jit(decode)`, `decode_eager` the
    eager `decode` (they differ on 10,592 of CMLS16's 65,536 states)."""
    j, t = _pair(name)
    states = np.arange(t.max_state + 1, dtype=np.int64)
    js = jnp.asarray(states.astype(np.uint32))
    ts = torch.from_numpy(states)
    np.testing.assert_array_equal(_bits(t.decode(ts).numpy()),
                                  _bits(jax.jit(j.decode)(js)))
    np.testing.assert_array_equal(_bits(t.decode_eager(ts).numpy()),
                                  _bits(j.decode(js)))


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_point_mass_and_increase_prob_equal_jax(name):
    j, t = _pair(name)
    states = np.arange(0, t.max_state + 1, dtype=np.int64)
    js = jnp.asarray(states.astype(np.float32))
    ts = torch.from_numpy(states)
    for fn in ("point_mass", "increase_prob"):
        got = _bits(getattr(t, fn)(ts).numpy())
        np.testing.assert_array_equal(got, _bits(getattr(j, fn)(js)))
        np.testing.assert_array_equal(got,
                                      _bits(jax.jit(getattr(j, fn))(js)))


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


def _nfold_grid(t):
    """Every state, each with n in fractions, 1-20, up to 1e5, a denormal
    (XLA reads it as 0) and near the state's steps (b^s, its float32
    neighbours, two and three steps' mass), and u in {0, 1 - 2^-24, a
    seeded draw}."""
    states = np.arange(t.max_state + 1, dtype=np.int64)
    fixed = np.array([0.0, 1e-40, 0.25, 0.5, 0.999, *range(1, 21), 100.0,
                      1000.0, 12345.678, 1e4, 1e5], np.float32)
    pm = t.point_mass(torch.from_numpy(states)).numpy()
    pm1 = t.point_mass(torch.from_numpy(states + 1)).numpy()
    near = np.stack([pm, np.nextafter(pm, np.float32(0)),
                     np.nextafter(pm, np.float32(np.inf)), 2 * pm,
                     pm + pm1], axis=1)
    n = np.concatenate([np.broadcast_to(fixed, (states.size, fixed.size)),
                        near], axis=1).astype(np.float32)
    s = np.broadcast_to(states[:, None], n.shape)
    rng = np.random.default_rng(1)
    u = np.stack([np.zeros(n.shape, np.float32),
                  np.full(n.shape, 1 - 2.0 ** -24, np.float32),
                  rng.random(n.shape, dtype=np.float32)])
    n = np.broadcast_to(n, u.shape)
    s = np.broadcast_to(s, u.shape)
    return (np.ascontiguousarray(s).ravel(), np.ascontiguousarray(n).ravel(),
            u.ravel())


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_nfold_equals_jax(name):
    """`nfold` equals `jax.jit(nfold)`, `nfold(eager=True)` the eager
    `nfold`, on every state and the grid of n and u (`_nfold_grid`)."""
    j, t = _pair(name)
    s, n, u = _nfold_grid(t)
    args = (jnp.asarray(s.astype(j.dtype)), jnp.asarray(n), jnp.asarray(u))
    ts, tn, tu = (torch.from_numpy(x) for x in (s, n, u))
    want = np.asarray(jax.jit(j.nfold)(*args)).astype(np.int64)
    np.testing.assert_array_equal(t.nfold(ts, tn, tu).numpy(), want)
    want = np.asarray(j.nfold(*args)).astype(np.int64)
    np.testing.assert_array_equal(t.nfold(ts, tn, tu, eager=True).numpy(),
                                  want)
    # n == 0 (and a denormal n) never moves a cell, in either package
    zero = n < 1e-38
    assert np.array_equal(want[zero], s[zero])


@pytest.mark.parametrize("name", LOG_COUNTERS)
def test_log_encode_floor_equals_jax(name):
    """`encode_floor` equals `jax.jit(encode_floor)` on 10^6 values up to
    twice max_value and at every state's decode and its neighbours."""
    j, t = _pair(name)
    rng = np.random.default_rng(3)
    d = t.decode(torch.arange(t.max_state + 1)).numpy()
    v = np.concatenate([
        (rng.random(1_000_000) * 2 * t.max_value).astype(np.float32),
        d, np.nextafter(d, np.float32(0)), np.nextafter(d, np.float32(np.inf))
    ]).astype(np.float32)
    want = np.asarray(jax.jit(j.encode_floor)(jnp.asarray(v)))
    got = t.encode_floor(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


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
