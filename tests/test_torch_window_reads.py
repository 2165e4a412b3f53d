"""The port's windowed reads against the JAX package's (CPU).

Both packages get the same seeded numpy inputs:

  * `ops.window_query_tables` (kernel 7's op) and `ops.window_query_stacked`
    (kernel 8's), all five storage formats, modes "sum" and "max", at the
    weights the zero-weight skip of the kernels must leave exact: bucket
    0 expired, every bucket expired, `n_buckets` 1..B, gamma; the
    stacked read with per-ring (R, N) probes and with (N,) probes shared
    by every ring (the port reads them with ring stride 0, the JAX op
    takes them broadcast);
  * the wrappers' CPU path (the plain versions) on (N,) probes shared by
    every ring;
  * windowed `CountService`s, the JAX one and the port's, read with
    `query` (full window, n_buckets, gamma, max) and `query_all` (shared
    and per-tenant probes) after rotations by one interval, by several
    and by more than B: the port keeps a plane's full-window weights
    until a cursor moves, and drops them when one does.

Tolerances, and why: CMS32 estimates are exact (integer counts times
0, 1 or gamma^age weights, multiplied and summed in bucket order by both
libraries, one IEEE rounding per step); log-cell estimates within 8 ulp,
the gap between JAX's and torch's float32 `expm1` on the CPU
(test_torch_counters).  The kernels themselves are held bit for bit to
the plain versions on the card (test_torch_cuda, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro.stream import CountService as JService
from repro.stream import WindowSpec as JWindowSpec
from repro.stream import window as jw
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sketch as ksk
from repro_torch.stream import CountService as TService
from repro_torch.stream import WindowSpec as TWindowSpec

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
B = 4
RINGS = 3
N = 96
CURSORS = np.asarray([2, 0, 3], np.int32)
# (n_buckets, gamma, buckets forced to weight 0)
WEIGHTS = {
    "full": (None, None, ()),
    "bucket0_expired": (None, None, (0,)),
    "all_expired": (None, None, tuple(range(B))),
    **{f"n_buckets={k}": (k, None, ()) for k in range(1, B + 1)},
    "gamma": (None, 0.9, ()),
    "n_buckets=2,gamma": (2, 0.5, ()),
}


def _specs(name, packed, width=512):
    js = jsk.SketchSpec(width=width, depth=2, counter=getattr(jc, name),
                        packed=packed)
    ts = tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                        packed=packed)
    return js, ts


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


def _close(got, want, spec) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if spec.counter.kind == "linear":
        np.testing.assert_array_equal(got, want)
    else:
        assert _ulp(got, want) <= 8


def _leaf(rng, js, lead):
    states = rng.integers(0, min(3000, js.counter.max_state + 1),
                          lead + (js.width,))
    if js.packed:
        return np.array(jsk.storage_table(jnp.asarray(states, jnp.uint32),
                                          js))
    return states.astype(np.asarray(jsk.init(js).table).dtype)


def _weights(case) -> np.ndarray:
    """(RINGS, B) float32 weights of a WEIGHTS case, from the reference's
    `window_weights_stacked` at CURSORS."""
    n_buckets, gamma, zeroed = WEIGHTS[case]
    wts = np.array(jw.window_weights_stacked(CURSORS, B, n_buckets, gamma))
    wts[:, list(zeroed)] = 0.0
    return wts


def _inputs(name, packed, seed):
    js, ts = _specs(name, packed)
    rng = np.random.default_rng(seed)
    leaf = _leaf(rng, js, (RINGS, B, 2))
    keys = rng.integers(0, 2**32, (RINGS, N), dtype=np.uint64).astype(
        np.uint32)
    keys[:, :6] = [0, 0xFFFFFFFF, 7, 7, 1, 0xFFFFFFFE]  # extremes, repeats
    return js, ts, leaf, keys


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("case", sorted(WEIGHTS))
@pytest.mark.parametrize("name,packed", FORMATS)
def test_window_query_tables_matches_jax(name, packed, case, mode):
    """Kernel 7's op on ring 1: the port's plain path against the
    reference's interpret-mode kernel at every weight case."""
    js, ts, leaf, keys = _inputs(name, packed, 0)
    wts = _weights(case)
    want = jops.window_query_tables(jnp.asarray(leaf[1]), js,
                                    jnp.asarray(keys[1]),
                                    jnp.asarray(wts[1]), mode=mode)
    with tops.audit_scope() as tally:
        got = tops.window_query_tables(tc.from_numpy(leaf[1], "cpu"), ts,
                                       keys[1], torch.from_numpy(wts[1]),
                                       mode=mode)
    assert dict(tally) == {"window_query": 1}
    _close(got, want, ts)
    if case == "all_expired":
        assert not got.any()


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("case", ["full", "bucket0_expired", "n_buckets=1",
                                  "gamma"])
@pytest.mark.parametrize("name,packed", FORMATS)
def test_window_query_stacked_matches_jax(name, packed, case, mode):
    """Kernel 8's op: per-ring (R, N) probes and (N,) probes shared by
    every ring, against the reference's interpret-mode stacked kernel
    (shared probes broadcast to (R, N) there)."""
    js, ts, leaf, keys = _inputs(name, packed, 1)
    wts = _weights(case)
    t_leaf = tc.from_numpy(leaf, "cpu")
    for probes in (keys, keys[2]):
        want = jops.window_query_stacked(
            jnp.asarray(leaf), js,
            jnp.asarray(np.broadcast_to(probes, keys.shape)),
            jnp.asarray(wts), mode=mode)
        with tops.audit_scope() as tally:
            got = tops.window_query_stacked(t_leaf, ts, probes,
                                            torch.from_numpy(wts), mode=mode)
        assert dict(tally) == {"window_query_stacked": 1}
        _close(got, want, ts)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_shared_keys_equal_per_ring_keys_on_the_plain_path(mode):
    """The wrappers' CPU path: (N,) probes shared by every ring answer
    exactly what the copied (R, N) probes do, and a one-ring read equals
    its row of the stacked read."""
    _, ts, leaf, keys = _inputs("CMLS16", True, 2)
    t_leaf = tc.from_numpy(leaf, "cpu")
    wts = torch.from_numpy(_weights("n_buckets=2,gamma"))
    kw = dict(seeds=tops._seeds_tuple(ts), width=ts.width, counter=ts.counter,
              mode=mode, cpl=ts.cells_per_lane)
    row = tc.from_numpy(keys[0], "cpu")
    copied = row.view(torch.int32).expand(RINGS, -1).contiguous().view(
        torch.uint32)
    want = ksk.window_query_stacked(t_leaf, copied, wts, **kw)
    assert torch.equal(ksk.window_query_stacked(t_leaf, row, wts, **kw), want)
    for r in range(RINGS):
        one = ksk.window_query(t_leaf[r], row, wts[r].contiguous(), **kw)
        assert torch.equal(one, want[r])


@pytest.mark.parametrize("bad", ["keys_rows", "weights", "mode", "seeds"])
def test_window_wrappers_reject_bad_inputs(bad):
    _, ts, leaf, keys = _inputs("CMS32", False, 3)
    t_leaf = tc.from_numpy(leaf, "cpu")
    wts = torch.from_numpy(_weights("full"))
    kw = dict(seeds=tops._seeds_tuple(ts), width=ts.width, counter=ts.counter,
              cpl=ts.cells_per_lane)
    probes = tc.from_numpy(keys, "cpu")
    if bad == "keys_rows":
        probes = probes[:2]
    elif bad == "weights":
        wts = wts[:, :2]
    elif bad == "mode":
        kw["mode"] = "mean"
    else:
        kw["seeds"] = kw["seeds"][:1]
    with pytest.raises(ValueError):
        ksk.window_query_stacked(t_leaf, probes, wts, **kw)


# --------------------------------------------------------------------------
# windowed services: query and query_all across rotations
# --------------------------------------------------------------------------

TENANTS = ("x", "y", "z")
# event-time steps of each stream: the watermark moves by one interval,
# by several, or by more than the ring (a full clear)
ROTATIONS = {"by_one": (70.0, 130.0), "by_several": (200.0, 390.0),
             "past_the_ring": (400.0, 1000.0)}


def _services(name, packed):
    js, ts = _specs(name, packed)
    jm = jsk.SketchSpec(width=256, depth=2, counter=jc.CMS32)
    tm = tsk.SketchSpec(width=256, depth=2, counter=tc.CMS32)
    a = JService(queue_capacity=2048, seed=5, track_top=4)
    b = TService(queue_capacity=2048, seed=5, track_top=4, device="cpu")
    a.add_tenant("m", spec=jm)
    b.add_tenant("m", spec=tm)
    for n in TENANTS:
        a.add_tenant(n, window=JWindowSpec(sketch=js, buckets=B,
                                           interval=60.0))
        b.add_tenant(n, window=TWindowSpec(sketch=ts, buckets=B,
                                           interval=60.0))
    return a, b, ts


def _events(rng, names):
    return {n: (rng.zipf(1.3, 300) % 200 + i * 1000).astype(np.uint32)
            for i, n in enumerate(names)}


def _reads_match(a, b, ts, probes) -> None:
    """query (four weightings) and query_all (shared and per-tenant
    probes) of both services, clean reads, with their dispatch audits."""
    for kw in ({}, {"n_buckets": 2}, {"gamma": 0.9}, {"mode": "max"}):
        with jops.audit_scope() as ta:
            want = a.query("y", probes[2], **kw)
        with tops.audit_scope() as tb:
            got = b.query("y", probes[2], **kw)
        assert dict(ta) == dict(tb) == {"window_query": 1}
        _close(got, want, ts)
    for keys in (probes[0], probes):
        with jops.audit_scope() as ta:
            want = a.query_all(keys)
        with tops.audit_scope() as tb:
            got = b.query_all(keys)
        assert dict(ta) == dict(tb) == {"query_many": 1,
                                        "window_query_stacked": 1}
        for n in b.tenants:
            _close(got[n], want[n], ts)


@pytest.mark.parametrize("rotation", sorted(ROTATIONS))
@pytest.mark.parametrize("name,packed", [("CMS32", False),
                                         ("CMLS16", True)])
def test_windowed_reads_across_rotations_match_jax(name, packed, rotation):
    a, b, ts = _services(name, packed)
    plane = b.planes[1]
    rng = np.random.default_rng(6)
    probes = np.stack([np.arange(40, dtype=np.uint32)]
                      + [np.arange(40, dtype=np.uint32) + i * 1000
                         for i in range(len(TENANTS))])
    ev = _events(rng, TENANTS)
    for svc in (a, b):
        svc.enqueue_many(ev, ts=10.0)
        svc.flush()
    _reads_match(a, b, ts, probes)
    cached = plane.full_weights()
    _reads_match(a, b, ts, probes)  # no cursor moved: the same weights
    assert plane.full_weights() is cached
    for ts_ in ROTATIONS[rotation]:
        before = plane.cursors.copy()
        ev = _events(rng, TENANTS[:2])
        for svc in (a, b):
            svc.enqueue_many(ev, ts=ts_)
            svc.flush()
        assert not np.array_equal(plane.cursors, before)
        _reads_match(a, b, ts, probes)
        fresh = plane.full_weights()
        assert fresh is not cached
        np.testing.assert_array_equal(
            fresh.numpy(), np.asarray(jw.window_weights_stacked(
                plane.cursors, B)))
        cached = fresh
    np.testing.assert_array_equal(
        plane.cursors, [int(a.planes[1].cursors[i]) for i in range(3)])


def test_query_all_with_interleaved_planes_matches_jax():
    """Per-tenant probes whose plane's tenants are not consecutive in the
    registry (a plain tenant registered between windowed ones): the port
    gathers the plane's rows on the device; answers equal the JAX
    service's, and a tenant added later changes the gather."""
    js, ts = _specs("CMLS8", False)
    jm = jsk.SketchSpec(width=256, depth=2, counter=jc.CMS32)
    tm = tsk.SketchSpec(width=256, depth=2, counter=tc.CMS32)
    a = JService(queue_capacity=2048, seed=7, track_top=4)
    b = TService(queue_capacity=2048, seed=7, track_top=4, device="cpu")
    jwin = JWindowSpec(sketch=js, buckets=B, interval=60.0)
    twin = TWindowSpec(sketch=ts, buckets=B, interval=60.0)
    rng = np.random.default_rng(8)
    for names in (("x", "m", "y"), ("n", "z")):
        for n in names:
            for svc, win, plain in ((a, jwin, jm), (b, twin, tm)):
                if n in ("m", "n"):
                    svc.add_tenant(n, spec=plain)
                else:
                    svc.add_tenant(n, window=win)
        ev = {n: (rng.zipf(1.3, 200) % 100).astype(np.uint32)
              for n in b.tenants}
        wev = {n: ev.pop(n) for n in list(ev) if n not in ("m", "n")}
        for svc in (a, b):
            svc.enqueue_many(ev)
            svc.enqueue_many(wev, ts=30.0)
            svc.flush()
        probes = rng.integers(0, 100, (len(b.tenants), 50)).astype(np.uint32)
        want, got = a.query_all(probes), b.query_all(probes)
        assert sorted(got) == sorted(want) == sorted(b.tenants)
        for n in b.tenants:
            _close(got[n], want[n], ts)
