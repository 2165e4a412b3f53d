"""The port's sketch and window algebra against the JAX package's (CPU).

Both packages get the same seeded numpy inputs and the same raw threefry
keys:

  * `CounterSpec.reencode_stochastic` (with and without a key), `merge`
    (max, estimate_sum) and its errors, `update_exact`, `update(mode=)`,
    the damped `update_batched` at several alphas and at depth 1;
  * `window_init` / `window_update` / `window_rotate` /
    `window_advance_to` (a non-monotone watermark, a jump past the whole
    ring), `decay` and its validation, `decayed_init` / `decayed_rotate`
    / `decayed_update` (with and without `age_step`) / `decayed_query`,
    and the decayed query's weights for B = 1..33, tail included;
  * the `convert.py` round trips of standalone structures, and the
    corpus estimators (`core/estimators.py`).

Tolerances, and why:
  * Cells and answers: none, in every format.  The port computes the
    reference's float32 graphs (`core/xla_f32.py`): the jitted one where
    the reference's call compiles (`update_exact`'s `lax.scan`, the
    window reads), the op-by-op one where it runs eagerly (`merge`,
    `decay`, the decayed fold and `update_batched` called outside jit,
    `eager=True`), and XLA's `**` (the C library's `powf`) for the
    damped update's ratio and the gamma weights.  Every test counts the
    differing cells and prints the count (pytest -s shows it): 0.
  * Decay weights: bit for bit, the tail's gamma^B included (the
    reference's `g ** B` is a binary exponentiation in float32
    multiplications, not a float pow).
  * Estimators: a float32 log of quotients of the estimates, within
    relative 1e-5 and absolute 1e-6 (a log near 0 is an absolute error:
    the quotient's ulp); LLR, a difference of x log x terms of size
    total * log(total), within 8 float32 ulp of that size.  The port's
    `log` there is torch's, not XLA's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import estimators as jest
from repro.core import sketch as jsk
from repro.core.hashing import combine2 as jcombine2
from repro.stream import WindowSpec as JWindowSpec
from repro.stream import window as jw
from repro_torch import convert
from repro_torch.core import counters as tc
from repro_torch.core import estimators as test_
from repro_torch.core import sketch as tsk
from repro_torch.core.hashing import combine2 as tcombine2
from repro_torch.stream import WindowSpec as TWindowSpec
from repro_torch.stream import window as tw

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
WIDTH = 8192
# 1,048,576 cells at depth 2: enough cells that a graph which rounds one
# state in 10^4 differently shows
RATE_WIDTH = 1 << 19
B = 4


def _specs(name, packed=False, width=WIDTH, depth=2):
    return (jsk.SketchSpec(width=width, depth=depth,
                           counter=getattr(jc, name), packed=packed),
            tsk.SketchSpec(width=width, depth=depth,
                           counter=getattr(tc, name), packed=packed))


def _key(*k):
    return np.asarray(k, np.uint32)


def _states(rng, spec, lead=(), hi=3000):
    """Random logical states (lead + (d, w)), int64, below min(hi, max)."""
    return rng.integers(0, min(hi, spec.counter.max_state + 1),
                        lead + (spec.depth, spec.width))


def _storage(states, jspec) -> np.ndarray:
    """Logical states -> the reference's storage table (numpy)."""
    dt = jspec.counter.dtype
    return np.array(jsk.storage_table(jnp.asarray(states).astype(dt), jspec))


def _logical(table, jspec) -> np.ndarray:
    return np.asarray(jsk.logical_table(jnp.asarray(table), jspec),
                      np.int64)


def _jt(table) -> torch.Tensor:
    return tc.from_numpy(np.asarray(table), "cpu")


def _cells_close(got, want, jspec, what: str) -> int:
    """Storage tables (or leaves) `got` (port) and `want` (reference)
    are equal, cell for cell.  Prints (and returns) the count of
    differing cells: 0."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    a, b = _logical(got, jspec), _logical(want, jspec)
    n = int((a != b).sum())
    print(f"{what}: {n} of {a.size} cells differ")
    np.testing.assert_array_equal(got, want, err_msg=what)
    return n


def _answers_close(got, want):
    """float32 answers equal, bit for bit."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _zipf(rng, n, mod=20_000):
    return (rng.zipf(1.3, n) % mod).astype(np.uint32)


# --------------------------------------------------------------------------
# reencode_stochastic, merge
# --------------------------------------------------------------------------

def test_reencode_uniforms_are_jax_draws_on_the_logical_shape():
    """One uniform a logical cell, not a storage lane: the draw over a
    packed spec's (d, width) equals jax.random.uniform on that shape."""
    from repro_torch.core import prng
    js, _ = _specs("CMLS8", True, width=1024)
    key = _key(5, 9)
    want = np.asarray(jax.random.uniform(key, (js.depth, js.width)))
    got = prng.uniform(key, (js.depth, js.width)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_rng", [True, False])
@pytest.mark.parametrize("name,packed", FORMATS)
def test_reencode_stochastic_matches(name, packed, with_rng):
    js, ts = _specs(name, packed, width=RATE_WIDTH)
    rng = np.random.default_rng(1)
    states = _states(rng, js)
    frac = rng.random(states.shape).astype(np.float32)
    # values between states, on states, and at the largest state
    v = np.asarray(js.counter.decode(jnp.asarray(states, jnp.float32)))
    v = (v * (1.0 + frac) + frac).astype(np.float32)
    v.reshape(-1)[:7] = np.float32(js.counter.max_value) * 1.5
    key = _key(0, 17) if with_rng else None
    want = np.asarray(js.counter.reencode_stochastic(jnp.asarray(v), key))
    got = ts.counter.reencode_stochastic(torch.from_numpy(v), key)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    cells = ts.counter.cells(got).numpy()
    want_cells = np.asarray(jnp.asarray(want).astype(js.counter.dtype),
                            np.int64)
    np.testing.assert_array_equal(
        cells.reshape(-1)[:7], np.full(7, js.counter.max_state))
    assert _cells_close(_storage(cells, js), _storage(want_cells, js), js,
                        f"reencode {name} packed={packed} rng={with_rng}") == 0


@pytest.mark.parametrize("name", ["CMLS16", "CMLS8"])
def test_floor_of_every_state_value(name):
    """Re-encoding an exact state value decode(s) without a key: both
    libraries' float32 floor lands s or s - 1, and on the same states,
    since the port decodes and re-encodes in the reference's float32 math
    (`xla_f32`).  torch's own expm1 / log1p moved 1,742 CMLS16 and 6
    CMLS8 states; the smallest input was a cell at state 1 merged with an
    empty one, where the reference lands 0."""
    js, ts = _specs(name, width=1, depth=1)
    states = np.arange(ts.counter.max_state + 1)
    got = ts.counter.reencode_stochastic(
        ts.counter.decode_eager(torch.from_numpy(states))).numpy()
    want = np.asarray(js.counter.reencode_stochastic(
        js.counter.decode(jnp.asarray(states, jnp.float32))))
    for x in (got, want):
        assert ((x == states) | (x == states - 1)).all()
    differ = np.flatnonzero(got != want)
    print(f"{name}: port low on {int((got != states).sum())}, reference "
          f"on {int((want != states).sum())}, apart on {differ.size} of "
          f"{states.size} state values, the smallest {differ[:3].tolist()}")
    assert differ.size == 0
    one = np.ones((1, 1), js.counter.dtype)
    zero = np.zeros((1, 1), js.counter.dtype)
    jm = jsk.merge(jsk.Sketch(jnp.asarray(one), js),
                   jsk.Sketch(jnp.asarray(zero), js), "estimate_sum")
    tm = tsk.merge(tsk.Sketch(_jt(one), ts), tsk.Sketch(_jt(zero), ts),
                   "estimate_sum")
    assert (int(np.asarray(jm.table)[0, 0]),
            int(tc.to_i64(tm.table)[0, 0])) == (0, 0)


@pytest.mark.parametrize("mode,with_rng", [("max", False),
                                           ("estimate_sum", True),
                                           ("estimate_sum", False)])
@pytest.mark.parametrize("name,packed", FORMATS)
def test_merge_matches(name, packed, mode, with_rng):
    js, ts = _specs(name, packed)
    rng = np.random.default_rng(2)
    ta, tb = _storage(_states(rng, js), js), _storage(_states(rng, js), js)
    key = _key(3, 4) if with_rng else None
    want = jsk.merge(jsk.Sketch(jnp.asarray(ta), js),
                     jsk.Sketch(jnp.asarray(tb), js), mode=mode, rng=key)
    got = tsk.merge(tsk.Sketch(_jt(ta), ts), tsk.Sketch(_jt(tb), ts),
                    mode=mode, rng=key)
    assert got.spec == ts and got.table.dtype == ts.storage_dtype
    # estimate_sum re-encodes in the reference's float32 math: exact
    assert _cells_close(tc.to_numpy(got.table), want.table, js,
                        f"merge {mode} {name} packed={packed} "
                        f"rng={with_rng}") == 0


def test_merge_estimate_sum_tracks_the_union_and_errors():
    js, ts = _specs("CMLS16")
    rng = np.random.default_rng(3)
    a = tsk.update_batched(tsk.init(ts, device="cpu"),
                           torch.from_numpy(_zipf(rng, 4000)), _key(0, 1))
    b = tsk.update_batched(tsk.init(ts, device="cpu"),
                           torch.from_numpy(_zipf(rng, 4000)), _key(0, 2))
    m = tsk.merge(a, b, mode="estimate_sum", rng=_key(0, 3))
    dec = ts.counter.decode
    va = dec(tsk.logical_table(a.table, ts))
    vb = dec(tsk.logical_table(b.table, ts))
    vm = dec(tsk.logical_table(m.table, ts))
    assert abs(float(vm.sum() / (va + vb).sum()) - 1.0) < 0.01
    with pytest.raises(ValueError, match="different specs"):
        tsk.merge(a, tsk.init(_specs("CMLS16", width=256)[1], device="cpu"))
    with pytest.raises(ValueError, match="unknown merge mode"):
        tsk.merge(a, b, mode="min")


# --------------------------------------------------------------------------
# updates: exact (Alg. 1), update(mode=), damped batched
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,packed", FORMATS)
def test_update_exact_matches(name, packed):
    """A few hundred sequential events on a narrow, crowded table (each
    event sees the earlier ones, so a one-state divergence would cascade
    into later decisions and show as more cells)."""
    js, ts = _specs(name, packed, width=256)
    rng = np.random.default_rng(4)
    base = _storage(_states(rng, js, hi=40), js)
    keys = _zipf(rng, 300, mod=400)
    key = _key(1, 99)
    want = jsk.update_exact(jsk.Sketch(jnp.asarray(base), js),
                            jnp.asarray(keys), key)
    got = tsk.update_exact(tsk.Sketch(_jt(base), ts), torch.from_numpy(keys),
                           key)
    n = _cells_close(tc.to_numpy(got.table), want.table, js,
                     f"update_exact {name} packed={packed}")
    assert n == 0  # 512 cells: the 1e-4 bound allows none
    assert not np.array_equal(tc.to_numpy(got.table), base)


@pytest.mark.parametrize("mode", ["exact", "batched"])
def test_update_mode_dispatch(mode):
    js, ts = _specs("CMLS8", False, width=512)
    keys = _zipf(np.random.default_rng(5), 200, mod=300)
    key = _key(7, 7)
    want = jsk.update(jsk.init(js), jnp.asarray(keys), key, mode=mode)
    got = tsk.update(tsk.init(ts, device="cpu"), torch.from_numpy(keys), key,
                     mode=mode)
    assert _cells_close(tc.to_numpy(got.table), want.table, js,
                        f"update mode={mode}") == 0
    with pytest.raises(ValueError, match="unknown update mode"):
        tsk.update(tsk.init(ts, device="cpu"), torch.from_numpy(keys), key,
                   mode="lazy")


@pytest.mark.parametrize("alpha", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("name,packed", FORMATS)
def test_damped_update_batched_matches(name, packed, alpha):
    js, ts = _specs(name, packed)
    rng = np.random.default_rng(6)
    base = _storage(_states(rng, js, hi=200), js)
    keys = _zipf(rng, 6000)
    key = _key(2, 11)
    want = jsk.update_batched(jsk.Sketch(jnp.asarray(base), js),
                              jnp.asarray(keys), key, damp_alpha=alpha)
    got = tsk.update_batched(tsk.Sketch(_jt(base), ts),
                             torch.from_numpy(keys), key, damp_alpha=alpha)
    _cells_close(tc.to_numpy(got.table), want.table, js,
                 f"damped alpha={alpha} {name} packed={packed}")
    plain = tsk.update_batched(tsk.Sketch(_jt(base), ts),
                               torch.from_numpy(keys), key)
    if name != "CMS32" or alpha != 0.0:
        assert not torch.equal(tc.signed_view(plain.table),
                               tc.signed_view(got.table))


@pytest.mark.parametrize("name", ["CMS32", "CMLS16"])
def test_damped_update_at_depth_one_is_not_damped(name):
    """The reference damps only for depth >= 2; at depth 1 a damped
    update equals the undamped one."""
    js, ts = _specs(name, depth=1)
    keys = _zipf(np.random.default_rng(7), 3000)
    key = _key(4, 4)
    want = jsk.update_batched(jsk.init(js), jnp.asarray(keys), key,
                              damp_alpha=1.0)
    got = tsk.update_batched(tsk.init(ts, device="cpu"),
                             torch.from_numpy(keys), key, damp_alpha=1.0)
    undamped = tsk.update_batched(tsk.init(ts, device="cpu"),
                                  torch.from_numpy(keys), key)
    assert torch.equal(tc.signed_view(got.table),
                       tc.signed_view(undamped.table))
    _cells_close(tc.to_numpy(got.table), want.table, js,
                 f"damped depth 1 {name}")


# --------------------------------------------------------------------------
# the standalone window ring
# --------------------------------------------------------------------------

def _wspecs(name, packed, buckets=B, interval=60.0, width=2048):
    js, ts = _specs(name, packed, width=width)
    return (JWindowSpec(sketch=js, buckets=buckets, interval=interval),
            TWindowSpec(sketch=ts, buckets=buckets, interval=interval))


def _same_ring(twin, jwin, jspec, what):
    assert twin.cursor == int(jwin.cursor), what
    assert twin.epoch == (None if jwin.epoch is None else int(jwin.epoch))
    _cells_close(tc.to_numpy(twin.tables), jwin.tables, jspec, what)


@pytest.mark.parametrize("name,packed", FORMATS)
def test_window_ring_matches(name, packed):
    """window_init -> updates, rotations and watermark advances (one
    interval, several, past the whole ring, jitter inside an interval)
    -> queries, in both packages."""
    jspec, tspec = _wspecs(name, packed)
    js = jspec.sketch
    jwin = jw.window_init(jspec)
    twin = tw.window_init(tspec, device="cpu")
    assert twin.tables.dtype == tspec.sketch.storage_dtype
    assert twin.tables.shape == tuple(jwin.tables.shape) and twin.cursor == 0
    rng = np.random.default_rng(8)
    probes = np.arange(64, dtype=np.uint32)
    steps = [("ts", 30.0), ("upd", 0), ("rot", None), ("upd", 1),
             ("ts", 95.0), ("upd", 2), ("ts", 100.0), ("upd", 3),
             ("ts", 250.0), ("upd", 4), ("ts", 250.0 + 60.0 * (B + 3)),
             ("upd", 5), ("rot", None), ("upd", 6)]
    for i, (op, arg) in enumerate(steps):
        if op == "ts":
            jwin = jw.window_advance_to(jwin, arg)
            twin = tw.window_advance_to(twin, arg)
        elif op == "rot":
            jwin = jw.window_rotate(jwin)
            twin = tw.window_rotate(twin)
        else:
            keys = _zipf(rng, 3000, mod=500)
            w = rng.integers(1, 4, keys.size).astype(np.float32)
            key = _key(9, arg)
            jwin = jw.window_update(jwin, jnp.asarray(keys), key,
                                    weights=jnp.asarray(w))
            twin = tw.window_update(twin, torch.from_numpy(keys), key,
                                    weights=torch.from_numpy(w))
        _same_ring(twin, jwin, js, f"{name} packed={packed} step {i} {op}")
    for kw in ({}, {"n_buckets": 2}, {"gamma": 0.8}, {"mode": "max"}):
        want = jw.window_query(jwin, jnp.asarray(probes), **kw)
        got = tw.window_query(twin, probes, **kw)
        _answers_close(got, want)


def test_window_advance_to_contract():
    jspec, tspec = _wspecs("CMS32", False, width=256)
    win = tw.window_init(tspec, device="cpu")
    assert win.epoch is None
    win = tw.window_advance_to(win, 125.0)          # first watermark
    assert (win.epoch, win.cursor) == (2, 0)
    same = tw.window_advance_to(win, 170.0)         # same interval: no-op
    assert same is win
    keys = torch.arange(50)
    win = tw.window_update(win, keys, _key(0, 1))
    with pytest.raises(ValueError, match="non-monotone watermark"):
        tw.window_advance_to(win, 110.0)
    far = tw.window_advance_to(win, 125.0 + 60.0 * (B + 2))
    assert far.epoch == 2 + B + 2 and far.cursor == (B + 2) % B
    assert int(tc.to_i64(far.tables).sum()) == 0    # every bucket expired
    assert int(tc.to_i64(win.tables).sum()) > 0     # the old ring unchanged
    with pytest.raises(ValueError, match="interval > 0"):
        tw.window_advance_to(tw.window_init(
            TWindowSpec(sketch=tspec.sketch, buckets=2), device="cpu"), 1.0)
    seeded = tw.window_init(tspec, epoch=7, device="cpu")
    assert seeded.epoch == 7
    assert jw.window_init(jspec, epoch=7).epoch == 7


# --------------------------------------------------------------------------
# decay, DecayedSketch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [0.5, 0.9])
@pytest.mark.parametrize("name,packed", FORMATS)
def test_decay_matches(name, packed, gamma):
    js, ts = _specs(name, packed, width=RATE_WIDTH)
    rng = np.random.default_rng(10)
    states = _states(rng, js)
    base = _storage(states, js)
    key = _key(6, 1)
    want = jw.decay(jsk.Sketch(jnp.asarray(base), js), gamma, key)
    got = tw.decay(tsk.Sketch(_jt(base), ts), gamma, key)
    assert _cells_close(tc.to_numpy(got.table), want.table, js,
                        f"decay gamma={gamma} {name} packed={packed}") == 0
    # unbiased in estimate space: the mean estimate scales by gamma
    dec = ts.counter.decode
    old = float(dec(tsk.logical_table(_jt(base), ts)).double().mean())
    new = float(dec(tsk.logical_table(got.table, ts)).double().mean())
    assert abs(new / (gamma * old) - 1.0) < 0.01


def test_decay_validation_and_identity():
    js, ts = _specs("CMLS16", width=512)
    base = _storage(_states(np.random.default_rng(11), js), js)
    s = tsk.Sketch(_jt(base), ts)
    for g in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="gamma"):
            tw.decay(s, g, _key(0, 0))
        with pytest.raises(ValueError, match="gamma"):
            tw.decayed_init(ts, gamma=g, device="cpu")
    same = tw.decay(s, 1.0, _key(0, 0))   # gamma 1 keeps every state
    assert torch.equal(tc.signed_view(same.table), tc.signed_view(s.table))


def _same_decayed(tds, jds, jspec, what):
    assert tds.cursor == int(jds.cursor), what
    assert _cells_close(tc.to_numpy(tds.tables), jds.tables, jspec,
                        what) == 0


@pytest.mark.parametrize("name,packed", FORMATS)
def test_decayed_sketch_matches(name, packed):
    js, ts = _specs(name, packed, width=2048)
    gamma, hist = 0.7, 3
    jds = jw.decayed_init(js, gamma=gamma, history=hist)
    tds = tw.decayed_init(ts, gamma=gamma, history=hist, device="cpu")
    assert tds.tables.shape == tuple(jds.tables.shape)
    assert tds.spec.buckets == hist and tds.gamma == gamma
    rng = np.random.default_rng(12)
    probes = np.arange(80, dtype=np.uint32)
    for i in range(7):   # past the ring: the tail folds twice or more
        keys = _zipf(rng, 2000, mod=300)
        age = i % 3 != 2
        key = _key(12, i)
        jds = jw.decayed_update(jds, jnp.asarray(keys), key, age_step=age)
        tds = tw.decayed_update(tds, torch.from_numpy(keys), key,
                                age_step=age)
        what = f"decayed {name} packed={packed} step {i} age_step={age}"
        _same_decayed(tds, jds, js, what)
        want = jw.decayed_query(jds, jnp.asarray(probes))
        _answers_close(tw.decayed_query(tds, probes), want)
        assert torch.equal(tw.decayed_query(tds, probes),
                           tw.decayed_query(tds, probes, engine="plain"))
    jds = jw.decayed_rotate(jds, _key(13, 0))
    tds = tw.decayed_rotate(tds, _key(13, 0))
    _same_decayed(tds, jds, js, f"decayed_rotate {name} packed={packed}")
    # the views: the ring's first B buckets and the tail at [B]
    assert tds.win.tables.shape[0] == hist and tds.win.cursor == tds.cursor
    assert torch.equal(tc.signed_view(tds.tail),
                       tc.signed_view(tds.tables[hist]))


def test_decayed_update_without_age_step_is_a_plain_update():
    js, ts = _specs("CMLS16", width=1024)
    tds = tw.decayed_init(ts, gamma=0.9, history=4, device="cpu")
    keys = torch.from_numpy(_zipf(np.random.default_rng(14), 1000))
    key = _key(14, 1)
    got = tw.decayed_update(tds, keys, key, age_step=False)
    from repro_torch.core import prng
    _, r_upd = prng.split(key, 2)
    want = tsk.update_batched(tsk.init(ts, device="cpu"), keys, r_upd)
    assert got.cursor == 0
    assert torch.equal(tc.signed_view(got.tables[0]),
                       tc.signed_view(want.table))
    assert int(tc.to_i64(got.tables[1:]).sum()) == 0


@pytest.mark.parametrize("gamma", [0.7, 0.98, 0.5, 0.999])
def test_decayed_query_weights_bit_for_bit(gamma, monkeypatch):
    """The weights `decayed_query` hands the window kernel, B = 1..33 at
    every cursor class: equal to the reference's bit for bit, the tail's
    gamma^B (binary exponentiation) included."""
    from repro.stream import window as jwin_mod
    seen = {}

    def spy(tables, spec, keys, weights, mode="sum", engine="auto"):
        seen["w"] = np.asarray(weights)
        return jnp.zeros(keys.shape, jnp.float32)

    monkeypatch.setattr(jwin_mod.ops, "window_query_tables", spy)
    js, ts = _specs("CMLS16", width=128)
    probes = jnp.zeros((1,), jnp.uint32)
    for b in range(1, 34):
        cursor = (7 * b) % b
        jds = jw.decayed_init(js, gamma=gamma, history=b)
        jds = jw.DecayedSketch(jds.tables, jnp.asarray(cursor, jnp.int32),
                               jds.spec, gamma)
        jw.decayed_query(jds, probes)
        got = tw.decayed_weights_host(cursor, b, gamma)
        assert got.dtype == np.float32 and got.shape == (b + 1,)
        np.testing.assert_array_equal(got.view(np.int32),
                                      seen["w"].view(np.int32),
                                      err_msg=f"B={b} gamma={gamma}")


# --------------------------------------------------------------------------
# convert: standalone structures across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,packed", FORMATS)
def test_convert_round_trips_and_continues(name, packed):
    """A JAX-built sketch, ring and decayed leaf go on in the port with
    the same answers, and come back byte for byte."""
    jspec, tspec = _wspecs(name, packed, width=1024)
    js, ts = jspec.sketch, tspec.sketch
    rng = np.random.default_rng(15)
    keys = _zipf(rng, 3000, mod=400)
    probes = np.arange(50, dtype=np.uint32)
    key = _key(15, 0)

    jsk_ = jsk.update_batched(jsk.init(js), jnp.asarray(keys), key)
    t = convert.sketch_from_numpy(np.asarray(jsk_.table), ts, device="cpu")
    np.testing.assert_array_equal(convert.sketch_to_numpy(t), jsk_.table)
    _answers_close(tsk.query(t, torch.from_numpy(probes)),
                   jsk.query(jsk_, jnp.asarray(probes)))

    jwin = jw.window_advance_to(jw.window_init(jspec), 200.0)
    jwin = jw.window_update(jwin, jnp.asarray(keys), key)
    twin = convert.window_from_numpy(
        {"tables": np.asarray(jwin.tables), "cursor": int(jwin.cursor),
         "epoch": int(jwin.epoch)}, tspec, device="cpu")
    back = convert.window_to_numpy(twin)
    np.testing.assert_array_equal(back["tables"], jwin.tables)
    assert (back["cursor"], back["epoch"]) == (int(jwin.cursor), 3)
    jwin = jw.window_update(jw.window_advance_to(jwin, 330.0),
                            jnp.asarray(keys[::-1].copy()), _key(15, 1))
    twin = tw.window_update(tw.window_advance_to(twin, 330.0),
                            torch.from_numpy(keys[::-1].copy()), _key(15, 1))
    _same_ring(twin, jwin, js, f"converted ring {name} packed={packed}")

    jds = jw.decayed_update(jw.decayed_init(js, gamma=0.8, history=2),
                            jnp.asarray(keys), key)
    tds = convert.decayed_from_numpy(
        {"tables": np.asarray(jds.tables), "cursor": int(jds.cursor)}, ts,
        0.8, device="cpu")
    assert tds.spec.buckets == 2
    np.testing.assert_array_equal(convert.decayed_to_numpy(tds)["tables"],
                                  jds.tables)
    jds = jw.decayed_update(jds, jnp.asarray(keys), _key(15, 2))
    tds = tw.decayed_update(tds, torch.from_numpy(keys), _key(15, 2))
    _same_decayed(tds, jds, js, f"converted decayed {name} packed={packed}")
    with pytest.raises(ValueError, match="shape"):
        convert.sketch_from_numpy(np.asarray(jsk_.table)[:1], ts,
                                  device="cpu")


# --------------------------------------------------------------------------
# estimators
# --------------------------------------------------------------------------

def _close32(got, want, scale=None):
    """Within relative 1e-5 and absolute 1e-6, or, for a difference of
    terms of size `scale` (per element), within 8 float32 ulp of it."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if scale is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        tol = 8 * np.finfo(np.float32).eps * np.asarray(scale, np.float64)
        assert (np.abs(got.astype(np.float64) - want) <= tol).all()


def _llr_scale(*k) -> np.ndarray:
    """Size of LLR's largest term: total * log(total) of its 2x2 table."""
    total = np.maximum(sum(np.asarray(x, np.float64) for x in k), 1.0)
    return total * np.log(total)


@pytest.mark.parametrize("name", ["CMS32", "CMLS16", "CMLS8"])
def test_estimators_match(name):
    js, ts = _specs(name, width=4096)
    rng = np.random.default_rng(16)
    tokens = _zipf(rng, 20_000, mod=800)
    left, right = tokens[:-1], tokens[1:]
    key = _key(16, 0)
    jbi = jcombine2(jnp.asarray(left), jnp.asarray(right))
    tbi = tcombine2(torch.from_numpy(left), torch.from_numpy(right))
    np.testing.assert_array_equal(tbi.numpy().astype(np.uint32),
                                  np.asarray(jbi))
    ju = jsk.update_batched(jsk.init(js), jnp.asarray(tokens), key)
    jb = jsk.update_batched(jsk.init(js), jbi, key)
    tu = convert.sketch_from_numpy(np.asarray(ju.table), ts, device="cpu")
    tb = convert.sketch_from_numpy(np.asarray(jb.table), ts, device="cpu")
    ql, qr = left[:300], right[:300]
    jl, jr = jnp.asarray(ql), jnp.asarray(qr)
    tl, tr = torch.from_numpy(ql), torch.from_numpy(qr)
    n_uni, n_bi = float(tokens.size), float(left.size)
    _close32(test_.pmi(tu, tb, tl, tr, n_uni, n_bi),
             jest.pmi(ju, jb, jl, jr, n_uni, n_bi))
    _close32(test_.llr_bigram(tu, tb, tl, tr, n_bi),
             jest.llr_bigram(ju, jb, jl, jr, n_bi),
             scale=np.full(ql.size, n_bi * np.log(n_bi)))
    _close32(test_.idf(tu, tl, 1234.0), jest.idf(ju, jl, 1234.0))
    tf = rng.random(300).astype(np.float32) * 5
    _close32(test_.tfidf(torch.from_numpy(tf), tu, tl, 1234.0),
             jest.tfidf(jnp.asarray(tf), ju, jl, 1234.0))
    c = rng.integers(0, 50, (3, 300)).astype(np.float32)
    _close32(test_.pmi_exact(*(torch.from_numpy(x) for x in c), 900.0,
                             800.0),
             jest.pmi_exact(*(jnp.asarray(x) for x in c), 900.0, 800.0))
    k = rng.integers(0, 40, (4, 300)).astype(np.float32)
    _close32(test_.log_likelihood_ratio(*(torch.from_numpy(x) for x in k)),
             jest.log_likelihood_ratio(*(jnp.asarray(x) for x in k)),
             scale=_llr_scale(*k))
