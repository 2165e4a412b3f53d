"""The port's windowed tenants against the JAX package's (CPU).

Both packages get the same seeded numpy inputs:

  * the plain versions of the three window-query kernels against the
    reference's interpret-mode Pallas kernels, all five storage formats,
    modes "sum" and "max";
  * `window_weights_stacked` (n_buckets, gamma) and the rotation
    (`ops.window_advance_rows`, `window_advance_steps`);
  * the native window flush against the `dense=True` restack oracle
    (uniform / hot / subset traffic, mid-rotation, packed), unlisted
    tenants preserved in place, rotation as one dispatch, flush before
    rotate;
  * whole windowed services, the JAX one and the port's, compared leaf
    by leaf through `convert.py`, with their dispatch audits, and the
    reference's ValueError contracts.

Tolerance: none.  Cell states, window answers (sum and max, with and
without gamma) and weights equal the reference's bit for bit: the port
computes the reference's jitted float32 graph (`core/xla_f32.py`) and
XLA's `powf` for the gamma weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro.kernels import sketch as jks
from repro.stream import CountService as JService
from repro.stream import WindowSpec as JWindowSpec
from repro.stream import window as jw
from repro_torch import convert
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.stream import CountService as TService
from repro_torch.stream import WindowSpec as TWindowSpec
from repro_torch.stream import window as tw

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
B = 4
TENANTS = ("x", "y", "z")


def _specs(name, packed=False, width=1024, buckets=B):
    js = jsk.SketchSpec(width=width, depth=2, counter=getattr(jc, name),
                        packed=packed)
    ts = tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                        packed=packed)
    return (JWindowSpec(sketch=js, buckets=buckets, interval=60.0),
            TWindowSpec(sketch=ts, buckets=buckets, interval=60.0))


def _answers_close(got, want):
    """float32 answers equal, bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _cells_close(a: np.ndarray, b: np.ndarray) -> None:
    """Storage tables equal, cell for cell."""
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _random_leaf(rng, spec, lead):
    states = rng.integers(0, min(3000, spec.counter.max_state + 1),
                          lead + (spec.width,))
    if spec.packed:
        return np.array(jsk.storage_table(jnp.asarray(states, jnp.uint32),
                                          spec))
    return states.astype(np.asarray(jsk.init(spec).table).dtype)


# --------------------------------------------------------------------------
# plain versions of kernels 7, 8, 9 against the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,packed", FORMATS)
def test_window_query_plains_match_pallas(name, packed):
    jwin, twin = _specs(name, packed)
    js, ts = jwin.sketch, twin.sketch
    rng = np.random.default_rng(0)
    leaf = _random_leaf(rng, js, (5, B, 2))
    keys = rng.integers(0, 4000, (3, 300)).astype(np.uint32)
    wts = rng.random((3, B)).astype(np.float32)
    wts[1, 2] = 0.0
    rows = np.asarray([4, 0, 2], np.int32)
    kw = dict(seeds=jops._seeds_tuple(js), width=js.width,
              counter=js.counter, interpret=True, cpl=js.cells_per_lane)
    t_leaf = tc.from_numpy(leaf, "cpu")
    t_keys = tc.from_numpy(keys, "cpu")
    seeds = tops._seed_tensor(ts, "cpu")
    tkw = dict(width=ts.width, counter=ts.counter, cpl=ts.cells_per_lane)
    for mode in ("sum", "max"):
        want = jks.window_query_stacked_rows_pallas(
            jnp.asarray(leaf), jnp.asarray(keys), jnp.asarray(wts),
            jnp.asarray(rows), mode=mode, **kw)
        got = tref.window_query_stacked_rows_plain(
            t_leaf, t_keys, torch.from_numpy(wts), torch.from_numpy(rows),
            seeds, mode=mode, **tkw)
        _answers_close(got, want)
        rings = leaf[rows]
        want_s = jks.window_query_stacked_pallas(
            jnp.asarray(rings), jnp.asarray(keys), jnp.asarray(wts),
            mode=mode, **kw)
        np.testing.assert_array_equal(np.asarray(want_s), np.asarray(want))
        got_s = tref.window_query_stacked_plain(
            tc.from_numpy(rings, "cpu"), t_keys, torch.from_numpy(wts),
            seeds, mode=mode, **tkw)
        assert torch.equal(got_s, got)
        want_1 = jks.window_query_pallas(
            jnp.asarray(rings[1]), jnp.asarray(keys[1]), jnp.asarray(wts[1]),
            mode=mode, **kw)
        got_1 = tref.window_query_plain(
            tc.from_numpy(rings[1], "cpu"), t_keys[1],
            torch.from_numpy(wts[1]), seeds, mode=mode, **tkw)
        _answers_close(got_1, want_1)
        assert torch.equal(got_1, got[1])
        # the reference's own XLA engine, through the same names: its
        # "max" equals its kernels'; its "sum" contracts bucket products
        # into the adds (FMAs, an ulp off the kernels on some keys;
        # ROADMAP §3), so a sum is held to the kernel family, the engine
        # the reference's service reads windows with on the CPU
        want_x = jax.jit(lambda *a: jops.ref.window_query_stacked_rows_ref(
            *a, jops._row_seeds_array(js), js.counter, mode=mode,
            cpl=js.cells_per_lane))(jnp.asarray(leaf), jnp.asarray(keys),
                                   jnp.asarray(wts), jnp.asarray(rows))
        got_x = tref.window_query_stacked_rows_ref(
            t_leaf, t_keys, torch.from_numpy(wts), torch.from_numpy(rows),
            seeds, ts.counter, mode=mode, cpl=ts.cells_per_lane)
        _answers_close(got_x, want_x if mode == "max" else want)


@pytest.mark.parametrize("n_buckets,gamma", [(None, None), (2, None),
                                             (None, 0.9), (3, 0.5)])
def test_window_weights_stacked_matches_jax(n_buckets, gamma):
    cursors = np.asarray([0, 1, 3, 2, 0], np.int32)
    want = np.asarray(jw.window_weights_stacked(cursors, B, n_buckets,
                                                gamma))
    got = tw.window_weights_stacked(cursors, B, n_buckets, gamma)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("buckets", [1, 2, 7, 8, 33, 64])
def test_window_weights_host_gamma_bit_for_bit(buckets):
    """`window_weights_host` against the reference's
    `window_weights_stacked` for 60 gammas in (0, 1] (1.0, tiny ones
    whose powers flush to zero, and a seeded spread) and every cursor of
    a ring of `buckets`, every window length: bit for bit (XLA's `**` is
    the C library's `powf`, `xla_f32.pow`)."""
    rng = np.random.default_rng(buckets)
    gammas = np.concatenate([[1.0, 0.5, 1e-3, 1e-30, np.nextafter(
        np.float32(1), np.float32(0))], rng.uniform(0.0, 1.0, 55)])
    cursors = np.arange(buckets, dtype=np.int32)
    for k in sorted({1, buckets // 2 or 1, buckets}):
        for g in gammas[gammas > 0]:
            want = np.asarray(jw.window_weights_stacked(cursors, buckets, k,
                                                        float(g)))
            got = tw.window_weights_host(cursors, buckets, k, float(g))
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32), err_msg=g)


def test_window_advance_rows_and_steps_match_jax():
    """The in-place masked rotation clears exactly the reference's
    buckets per ring (steps 0 untouched, steps >= B a full clear), and
    the one-ring `window_advance_steps` agrees."""
    jwin, twin = _specs("CMLS16")
    rng = np.random.default_rng(1)
    leaf = _random_leaf(rng, jwin.sketch, (5, B, 2))
    cursors = np.asarray([0, 1, 2, 3, 1], np.int32)
    steps = np.asarray([0, 1, 2, 5, 3], np.int32)
    want = np.asarray(jops.window_advance_rows(jnp.asarray(leaf), cursors,
                                               steps))
    t_leaf = tc.from_numpy(leaf, "cpu")
    ptr = t_leaf.data_ptr()
    with tops.audit_scope() as tally:
        got = tops.window_advance_rows(t_leaf, cursors, steps)
    assert dict(tally) == {"window_advance_rows": 1}
    assert got.data_ptr() == ptr  # in place
    np.testing.assert_array_equal(tc.to_numpy(got), want)
    for r in range(5):
        jr = jw.window_advance_steps(
            jw.WindowedSketch(tables=jnp.asarray(leaf[r]),
                              cursor=jnp.asarray(cursors[r], jnp.int32),
                              spec=jwin, epoch=jnp.asarray(7, jnp.int32)),
            int(steps[r]))
        tr = tw.window_advance_steps(
            tw.WindowedSketch(tables=tc.from_numpy(leaf[r], "cpu"),
                              cursor=int(cursors[r]), spec=twin, epoch=7),
            int(steps[r]))
        np.testing.assert_array_equal(tc.to_numpy(tr.tables),
                                      np.asarray(jr.tables))
        assert tr.cursor == int(jr.cursor) and tr.epoch == int(jr.epoch)


# --------------------------------------------------------------------------
# the window plane: native flush, rotation
# --------------------------------------------------------------------------

UNIFORM = {"x": (400, 1), "y": (300, 2), "z": (350, 3)}
HOT1 = {"y": (900, 4)}
SUBSET = {"x": (500, 5), "z": (250, 6)}
REGIMES = {"uniform": UNIFORM, "hot1": HOT1, "subset": SUBSET}


def _zipf(n, vocab, seed):
    return (np.random.default_rng(seed).zipf(1.3, n) % vocab).astype(
        np.uint32)


def _tservice(twin, track_top=8):
    svc = TService(queue_capacity=8192, seed=3, track_top=track_top,
                   device="cpu")
    for n in TENANTS:
        svc.add_tenant(n, window=twin)
    return svc


def _flush_pair(twin, regime, mid_rotation):
    svcs = [_tservice(twin) for _ in range(2)]
    for svc in svcs:
        for name, (n, seed) in regime.items():
            svc.enqueue(name, _zipf(n, 200, seed), ts=10.0)
        if mid_rotation:
            svc.flush()
            for name, ts, seed in (("x", 70.0, 11), ("z", 130.0, 12)):
                svc.enqueue(name, _zipf(200, 200, seed), ts=ts)
    native, dense = svcs
    native.flush()
    for p in dense.planes:
        p.flush(dense=True)
    return native.planes[0], dense.planes[0]


def _assert_plane_equal(pa, pb):
    assert torch.equal(tc.signed_view(pa.tables), tc.signed_view(pb.tables))
    np.testing.assert_array_equal(pa.cursors, pb.cursors)
    assert pa.epochs == pb.epochs
    for key in ("keys", "estimates", "filled"):
        assert torch.equal(getattr(pa.tracker, key).view(torch.int32)
                           if key == "keys" else getattr(pa.tracker, key),
                           getattr(pb.tracker, key).view(torch.int32)
                           if key == "keys" else getattr(pb.tracker, key))


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("mid_rotation", [False, True])
def test_native_flush_matches_dense_restack(regime, mid_rotation):
    """The in-place flat-row flush reproduces the gather / update_many /
    scatter oracle exactly (port against port): tables, cursors, heaps."""
    _, twin = _specs("CMLS16", width=2048)
    _assert_plane_equal(*_flush_pair(twin, REGIMES[regime], mid_rotation))


@pytest.mark.parametrize("name", ["CMS32", "CMLS16", "CMLS8"])
def test_native_flush_matches_dense_packed(name):
    _, twin = _specs(name, packed=name != "CMS32", width=2048)
    _assert_plane_equal(*_flush_pair(twin, UNIFORM, True))


def test_native_flush_preserves_unlisted_tenants():
    """The flush writes through a view of the leaf (same storage) and
    only the flushed tenant's active bucket moves."""
    _, twin = _specs("CMLS16", width=2048)
    native, _ = _flush_pair(twin, UNIFORM, False)
    ptr = native.tables.data_ptr()
    before = tc.to_numpy(native.tables).copy()
    native.ring.append([1], [_zipf(100, 200, 9)])
    native.flush()
    assert native.tables.data_ptr() == ptr
    after = tc.to_numpy(native.tables)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[2], before[2])
    cur = int(native.cursors[1])
    for bkt in range(B):
        if bkt != cur:
            np.testing.assert_array_equal(after[1, bkt], before[1, bkt])
    assert not np.array_equal(after[1, cur], before[1, cur])


def test_rotation_is_one_dispatch_for_many_tenants():
    _, twin = _specs("CMLS16", width=2048)
    svc = _tservice(twin)
    plane = svc.planes[0]
    for name, (n, seed) in UNIFORM.items():
        svc.enqueue(name, _zipf(n, 200, seed), ts=10.0)
    svc.flush()
    disp0 = plane._m_rotation_dispatches.value
    with tops.audit_scope() as tally:
        plane.advance_many([(0, 70.0), (1, 190.0), (2, 70.0)], svc.flush)
    assert dict(tally) == {"window_advance_rows": 1}
    assert plane._m_rotation_dispatches.value == disp0 + 1
    np.testing.assert_array_equal(plane.cursors, [1, 3, 1])
    assert plane.epochs == [1, 3, 1]


def test_rotation_with_pending_fill_flushes_first():
    """Buffered events land in the PRE-rotation bucket, then the ring
    rotates: {update_rows: 1, window_query_stacked: 1} then one
    window_advance_rows."""
    _, twin = _specs("CMS32", width=2048)
    svc = _tservice(twin)
    plane = svc.planes[0]
    svc.enqueue("x", np.full(64, 7, np.uint32), ts=10.0)
    with tops.audit_scope() as tally:
        svc.enqueue("x", np.full(32, 7, np.uint32), ts=70.0)
    assert dict(tally) == {"update_rows": 1, "window_query_stacked": 1,
                           "window_advance_rows": 1, "queue_append": 1}
    assert plane.cursors[0] == 1
    # the read flushes the 32 new events into the new bucket
    np.testing.assert_array_equal(
        svc.query("x", [7], n_buckets=1).numpy(), [32.0])
    np.testing.assert_array_equal(svc.query("x", [7]).numpy(), [96.0])


# --------------------------------------------------------------------------
# whole services against the JAX service
# --------------------------------------------------------------------------

def _audit(a, b, fn):
    with jops.audit_scope() as ta:
        ra = fn(a)
    with tops.audit_scope() as tb:
        rb = fn(b)
    assert dict(ta) == dict(tb), (dict(ta), dict(tb))
    return ra, rb, dict(tb)


def _pair(name, packed, track_top=8):
    jwin, twin = _specs(name, packed, width=512)
    jm = jsk.SketchSpec(width=256, depth=2, counter=jc.CMS32)
    tm = tsk.SketchSpec(width=256, depth=2, counter=tc.CMS32)
    a = JService(queue_capacity=4096, seed=4, track_top=track_top)
    b = TService(queue_capacity=4096, seed=4, track_top=track_top,
                 device="cpu")
    a.add_tenant("m", spec=jm)
    b.add_tenant("m", spec=tm)
    for n in TENANTS:
        a.add_tenant(n, window=jwin)
        b.add_tenant(n, window=twin)
    return a, b, twin


def _compare_leaves(a, b, twin):
    ta = jax.tree_util.tree_map(np.asarray, a._tree())
    meta, tb = convert.service_to_numpy(b)
    ma = a._meta()
    assert meta["windows"] == [{k: v for k, v in wm.items()}
                               for wm in ma["windows"]]
    assert meta["planes"][0]["rng_draws"] == ma["planes"][0]["rng_draws"]
    for la, lb in zip(ta["planes"], tb["planes"]):
        for key in ("tables", "queue", "fill"):
            np.testing.assert_array_equal(la[key], lb[key])
    for la, lb in zip(ta["windows"], tb["windows"]):
        for key in ("cursor", "epoch", "queue", "fill"):
            assert la[key].dtype == lb[key].dtype, key
            np.testing.assert_array_equal(la[key], lb[key])
        _cells_close(lb["tables"], la["tables"])
        if "topk" in la:
            np.testing.assert_array_equal(la["topk"]["filled"],
                                          lb["topk"]["filled"])


def _stream(a, b, seed=0, steps=10):
    """Windowed microbatches at event times ts += exponential(40 s): the
    rings rotate by one, by several, and (one jump of 5 intervals) all B
    buckets, each crossing with pending fill; the plain tenant takes
    traffic too."""
    rng = np.random.default_rng(seed)
    ts = 5.0
    audits = []
    for step in range(steps):
        ts += 300.0 if step == 6 else float(rng.exponential(40.0))
        live = TENANTS[:1 + step % 3]
        ev = {n: (rng.zipf(1.3, 200 + 150 * i) % 300 + i * 1000).astype(
            np.uint32) for i, n in enumerate(live)}
        audits.append(_audit(a, b, lambda s: s.enqueue_many(ev, ts=ts))[2])
        if step == 6:  # a full clear, with pending fill flushed first
            assert audits[-1]["window_advance_rows"] == 1
            assert audits[-1].get("update_rows", 0) >= 1
        mev = {"m": (rng.zipf(1.3, 100) % 50).astype(np.uint32)}
        _audit(a, b, lambda s: s.enqueue_many(mev))
    return audits


@pytest.mark.parametrize("name,packed", [("CMS32", False),
                                         ("CMLS16", True)])
def test_windowed_service_matches_jax(name, packed):
    a, b, twin = _pair(name, packed)
    audits = _stream(a, b)
    rotations = [t.get("window_advance_rows", 0) for t in audits]
    assert sum(rotations) >= 4
    # a windowed flush is {update_rows: classes, window_query_stacked: 1}
    assert any(t.get("update_rows") and t.get("window_query_stacked") == 1
               for t in audits)
    plane = b.planes[1]
    assert max(plane.epochs) - min(e for e in plane.epochs) >= 0
    probes = np.stack([np.arange(40, dtype=np.uint32)]
                      + [np.arange(40, dtype=np.uint32) + i * 1000
                         for i in range(3)])
    _, _, tally = _audit(a, b, lambda s: s.flush())
    assert tally["window_query_stacked"] == 1 and tally["update_rows"] >= 1
    # a clean read: one dispatch per plane, no update dispatch
    qa, qb, tally = _audit(a, b, lambda s: s.query_all(probes))
    assert tally == {"query_many": 1, "window_query_stacked": 1}
    for n in b.tenants:
        _answers_close(qb[n], qa[n])
    for kw in ({}, {"n_buckets": 3}, {"mode": "max"}, {"gamma": 0.9}):
        ya, yb, tally = _audit(a, b, lambda s: s.query("y", probes[2], **kw))
        assert tally == {"window_query": 1}
        _answers_close(yb, ya)
        (ka, ea), (kb, eb), tally = _audit(
            a, b, lambda s: s.topk("x", 5, **kw))
        assert tally == {"window_query_stacked": 1}
        np.testing.assert_array_equal(kb, ka)
        _answers_close(eb, ea)
    _compare_leaves(a, b, twin)
    assert a.epoch_of("z") == b.epoch_of("z")


def test_windowed_untracked_service_matches_jax():
    a, b, twin = _pair("CMLS8", False, track_top=None)
    audits = _stream(a, b, seed=1)
    assert all("window_query_stacked" not in t for t in audits)
    _audit(a, b, lambda s: s.flush())
    _compare_leaves(a, b, twin)


def test_window_service_carries_over_from_jax_mid_stream():
    """A JAX service carried into the port mid-stream (pending events,
    mid-rotation cursors and watermarks) continues identically."""
    a, first, twin = _pair("CMS32", False)
    _stream(a, first, seed=2, steps=5)
    assert a.dirty_planes
    b = convert.service_from_numpy(
        a._meta(), jax.tree_util.tree_map(np.asarray, a._tree()),
        device="cpu")
    _compare_leaves(a, b, twin)
    rng = np.random.default_rng(3)
    for ts in (400.0, 460.0, 900.0):
        ev = {n: rng.integers(0, 300, 200).astype(np.uint32)
              for n in TENANTS}
        _audit(a, b, lambda s: s.enqueue_many(ev, ts=ts))
    _audit(a, b, lambda s: s.flush())
    _compare_leaves(a, b, twin)
    meta, tree = convert.service_to_numpy(b)
    c = convert.service_from_numpy(meta, tree, device="cpu")
    _compare_leaves(a, c, twin)


# --------------------------------------------------------------------------
# the reference's ValueError contracts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda s: s.enqueue("x", [1], ts=5.0),                # behind watermark
    lambda s: s.enqueue_many({"x": [1]}, ts=5.0),
    lambda s: s.enqueue("m", [1], ts=200.0),              # plain tenant
    lambda s: s.enqueue_many({"m": [1], "x": [1]}, ts=200.0),
    lambda s: s.query("m", [1], n_buckets=2),             # window args
    lambda s: s.topk("m", 2, gamma=0.5),
    lambda s: s.epoch_of("m"),
    lambda s: s.add_tenant("w", spec=s.spec_of("m"), window=s._wspec),
    lambda s: s.query("x", [1], n_buckets=B + 1),
    lambda s: s.query("x", [1], gamma=1.5),
])
def test_window_contracts_raise_value_error(call):
    _, twin = _specs("CMS32", width=512)
    svc = TService(queue_capacity=1024, track_top=4, device="cpu")
    svc._wspec = twin
    svc.add_tenant("m", spec=tsk.SketchSpec(width=256, counter=tc.CMS32))
    svc.add_tenant("x", window=twin)
    svc.enqueue("x", [3], ts=130.0)
    with pytest.raises(ValueError):
        call(svc)
