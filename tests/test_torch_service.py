"""The port's counting service against the JAX package's, end to end.

Both services run on the CPU over the same event stream (made with numpy
from a seed): `enqueue_many` (whole-plane and one-row appends),
`enqueue` with a queue-pressure flush, `flush`, `query_all`, `query`,
`topk`, `sketch_of`.  A flush lands rows grouped into several fill
classes, because one tenant gets more traffic than the others.

Every format must match exactly: tables, rings, fills, PRNG draws,
trackers, estimates (bit for bit) and the per-call dispatch audit.  The
port computes the reference's float32 graphs (`core/xla_f32.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro.stream import CountService as JService
from repro.stream import TierSpec as JTierSpec
from repro_torch import convert
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.stream import CountService as TService
from repro_torch.stream import TierSpec as TTierSpec

NAMES = ["a", "b", "c"]
CAP = 2048


def _specs(name, packed, width=512):
    return (jsk.SketchSpec(width=width, depth=2, counter=getattr(jc, name),
                           packed=packed),
            tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                           packed=packed))


def _pair(name, packed, seed=3, cap=CAP):
    js, ts = _specs(name, packed)
    a = JService(js, tenants=NAMES, queue_capacity=cap, seed=seed,
                 track_top=8)
    b = TService(ts, tenants=NAMES, queue_capacity=cap, seed=seed,
                 track_top=8, device="cpu")
    jm, tm = _specs("CMS32", False, width=256)
    a.add_tenant("m", spec=jm)
    b.add_tenant("m", spec=tm)
    return a, b


class Audit:
    """Runs one call on both services and compares their dispatch
    tallies."""

    def __init__(self):
        self.calls = []

    def __call__(self, fn_a, fn_b):
        with jops.audit_scope() as ta:
            ra = fn_a()
        with tops.audit_scope() as tb:
            rb = fn_b()
        self.calls.append((dict(ta), dict(tb)))
        assert dict(ta) == dict(tb)
        return ra, rb


def _stream(a, b, steps, seed=0, per_tenant=500, single=700):
    """`steps` x (enqueue_many of `per_tenant` Zipf keys per tenant + 200
    for "m", then `single` random keys for "b" alone)."""
    rng = np.random.default_rng(seed)
    audit = Audit()
    for _ in range(steps):
        ev = {n: (rng.zipf(1.3, per_tenant) % 300 + i * 1000).astype(
            np.uint32) for i, n in enumerate(NAMES)}
        ev["m"] = (rng.zipf(1.3, 200) % 50).astype(np.uint32)
        audit(lambda: a.enqueue_many(ev), lambda: b.enqueue_many(ev))
        hot = rng.integers(0, 2**32, single, dtype=np.uint64).astype(
            np.uint32)
        hot[:2] = [0, 0xFFFF_FFFF]
        audit(lambda: a.enqueue("b", hot), lambda: b.enqueue("b", hot))
    return audit


def _leaves(a, b):
    ta = jax.tree_util.tree_map(np.asarray, a._tree())
    _, tb = convert.service_to_numpy(b)
    return ta["planes"], tb["planes"]


def _cells(leaf, spec):
    if spec.packed:
        return np.asarray(jc.unpack_table(jnp.asarray(leaf),
                                          spec.counter.bits)).astype(np.int64)
    return leaf.astype(np.int64)


def _compare(a, b, name, packed):
    """Every leaf equal: rings, fills, draws, tables and trackers (their
    estimates bit for bit); returns the count of differing cells."""
    js, _ = _specs(name, packed)
    la, lb = _leaves(a, b)
    assert [p["rng_draws"] for p in a._meta()["planes"]] == \
        [p.rng.draws for p in b.planes]
    assert a.stats == b.stats
    differing = 0
    for pa, pb in zip(la, lb):
        for key in ("queue", "fill"):
            assert pa[key].dtype == pb[key].dtype
            assert np.array_equal(pa[key], pb[key]), key
        assert pa["tables"].dtype == pb["tables"].dtype
        diff = _cells(pb["tables"], js) - _cells(pa["tables"], js)
        differing += int((diff != 0).sum())
        assert np.array_equal(pa["tables"], pb["tables"])
        for key in ("keys", "estimates", "filled"):
            x, y = np.asarray(pa["topk"][key]), np.asarray(pb["topk"][key])
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            assert np.array_equal(x, y), key
    return differing


def _reads(a, b, name, audit):
    probes = np.stack([np.arange(40, dtype=np.uint32) + i * 1000
                       for i in range(3)] + [np.arange(40, dtype=np.uint32)])
    qa, qb = audit(lambda: a.query_all(probes), lambda: b.query_all(probes))
    one_a, one_b = audit(lambda: a.query("b", probes[1]),
                         lambda: b.query("b", probes[1]))
    top_a, top_b = audit(lambda: a.topk("a", 5), lambda: b.topk("a", 5))
    for n in a.tenants:
        x, y = np.asarray(qa[n]), qb[n].numpy()
        assert np.array_equal(x.view(np.int32), y.view(np.int32)), n
    assert np.array_equal(one_b.numpy(), qb["b"].numpy())
    assert np.array_equal(top_a[0], top_b[0])
    assert np.array_equal(np.asarray(top_a[1]).view(np.int32),
                          np.asarray(top_b[1]).view(np.int32))
    ska, skb = audit(lambda: a.sketch_of("c"), lambda: b.sketch_of("c"))
    assert skb.spec.width == ska.spec.width
    got, want = tc.to_numpy(skb.table), np.asarray(ska.table)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_cms32_service_exact_with_audit():
    a, b = _pair("CMS32", False)
    audit = _stream(a, b, steps=3)
    assert any("update_score_rows" in ta for ta, _ in audit.calls), \
        "the stream never hit queue pressure"
    audit(lambda: a.flush(), lambda: b.flush())
    _reads(a, b, "CMS32", audit)
    assert _compare(a, b, "CMS32", False) == 0
    # a flush over rows of several fill classes is one dispatch per class
    assert max(ta.get("update_score_rows", 0) for ta, _ in audit.calls) >= 2
    # a clean read issues no update dispatch
    _, tb = audit.calls[-2]
    assert "update_score_rows" not in tb


@pytest.mark.parametrize("name,packed", [("CMLS16", False), ("CMLS16", True),
                                         ("CMLS8", False), ("CMLS8", True)])
def test_log_service_exact(name, packed):
    # a one-chunk ring: b's extra traffic overflows it, so enqueue_many
    # falls back to enqueue and flushes the plane on queue pressure, and
    # every flush lands all three rows in one fill class
    a, b = _pair(name, packed, cap=1024)
    audit = _stream(a, b, steps=3, seed=1, per_tenant=512, single=300)
    assert any("update_score_rows" in ta for ta, _ in audit.calls)
    audit(lambda: a.flush(), lambda: b.flush())
    _reads(a, b, name, audit)
    assert _compare(a, b, name, packed) == 0


def test_carry_over_mid_stream_stays_equal():
    """A JAX service carried into the port mid-stream (pending ring
    events and trackers included) and continued in both packages."""
    a, first = _pair("CMS32", False)
    _stream(a, first, steps=1, seed=5)
    assert a.dirty_planes  # pending events cross over in the ring
    meta = a._meta()
    tree = jax.tree_util.tree_map(np.asarray, a._tree())
    b = convert.service_from_numpy(meta, tree, device="cpu")
    la, lb = _leaves(a, b)
    for pa, pb in zip(la, lb):
        for key in ("tables", "queue", "fill"):
            assert np.array_equal(pa[key], pb[key])
    audit = _stream(a, b, steps=2, seed=6)
    audit(lambda: a.flush(), lambda: b.flush())
    _reads(a, b, "CMS32", audit)
    assert _compare(a, b, "CMS32", False) == 0


def test_service_to_numpy_round_trips_through_service_from_numpy():
    a, b = _pair("CMLS8", True, cap=1024)
    _stream(a, b, steps=3, seed=1, per_tenant=512, single=300)
    meta, tree = convert.service_to_numpy(b)
    c = convert.service_from_numpy(meta, tree, device="cpu")
    meta2, tree2 = convert.service_to_numpy(c)
    assert meta2["planes"] == meta["planes"]
    for pa, pb in zip(tree["planes"], tree2["planes"]):
        for key in ("tables", "queue", "fill"):
            assert np.array_equal(pa[key], pb[key])


def _tiered_pair(seed=3, cap=CAP):
    """`_pair`'s CMS32 services with one hot tenant a plane."""
    js, ts = _specs("CMS32", False)
    a = JService(js, tenants=NAMES, queue_capacity=cap, seed=seed,
                 track_top=8, tier=JTierSpec(max_hot_tenants=1))
    b = TService(ts, tenants=NAMES, queue_capacity=cap, seed=seed,
                 track_top=8, tier=TTierSpec(max_hot_tenants=1),
                 device="cpu")
    jm, tm = _specs("CMS32", False, width=256)
    a.add_tenant("m", spec=jm)
    b.add_tenant("m", spec=tm)
    return a, b


@pytest.mark.parametrize("way", ["snapshot", "convert"])
def test_tiered_state_crosses_over_mid_stream(way, tmp_path):
    """A tiered JAX service, carried into the port mid-stream through a
    v8 snapshot or through `convert` (membership, cold stores, queue
    mirrors, trackers, pending events), then continued in both packages:
    the same dispatch audit, leaves and answers (CMS32: exact)."""
    a, first = _tiered_pair()
    _stream(a, first, steps=2, seed=5)
    assert a.dirty_planes
    if way == "snapshot":
        a.snapshot(str(tmp_path), 1)
        b = TService.restore(str(tmp_path), device="cpu")
    else:
        b = convert.service_from_numpy(
            a._meta(), jax.tree_util.tree_map(np.asarray, a._tree()),
            device="cpu")
    assert b.tier_occupancy() == a.tier_occupancy() == {
        "p0": {"hot": 1, "cold": 2}, "p1": {"hot": 1, "cold": 0}}
    assert _compare(a, b, "CMS32", False) == 0
    audit = _stream(a, b, steps=2, seed=6)
    audit(lambda: a.flush(), lambda: b.flush())
    _reads(a, b, "CMS32", audit)
    assert _compare(a, b, "CMS32", False) == 0


def test_out_of_slice_features_raise(tmp_path):
    """The damped update, out of the earlier slices, now runs on a
    tenant's sketch as the reference's does; an unknown update or merge
    mode raises ValueError, as in the reference."""
    js, ts = _specs("CMS32", False)
    a = JService(js, tenants=["a"], track_top=4)
    b = TService(ts, tenants=["a"], track_top=4, device="cpu")
    keys = np.arange(300, dtype=np.uint32) % 97
    a.enqueue("a", keys)
    b.enqueue("a", keys)
    key = np.asarray([5, 6], np.uint32)
    want = jsk.update_batched(a.sketch_of("a"), jnp.asarray(keys), key,
                              damp_alpha=0.5)
    got = tsk.update_batched(b.sketch_of("a"), torch.from_numpy(keys), key,
                             damp_alpha=0.5)
    np.testing.assert_array_equal(tc.to_numpy(got.table),
                                  np.asarray(want.table))
    with pytest.raises(ValueError, match="unknown update mode"):
        tsk.update(got, torch.from_numpy(keys), key, mode="eager")
    with pytest.raises(ValueError, match="unknown merge mode"):
        tsk.merge(got, got, mode="sum")


@pytest.mark.parametrize("tier,exc", [
    (lambda: TTierSpec(max_hot_tenants=0), ValueError),
    (lambda: TTierSpec(max_hot_tenants=2, policy="random"), ValueError),
    (lambda: object(), TypeError)], ids=["no_slots", "bad_policy", "object"])
def test_bad_tier_spec_raises(tier, exc):
    """A TierSpec with no hot slot or an unknown policy raises ValueError,
    as the reference's does; something else than a TierSpec TypeError."""
    _, ts = _specs("CMS32", False)
    with pytest.raises(exc):
        TService(ts, track_top=4, tier=tier(), device="cpu")


@pytest.mark.parametrize("kw", [dict(queue_capacity=0),
                                dict(track_top=0)])
def test_out_of_slice_construction_raises(kw):
    """Every construction argument of the reference is in the port now
    (the accuracy probe came last: `probe=` builds); bad values raise
    ValueError, as the reference's do."""
    from repro_torch.obs import AccuracyProbe
    _, ts = _specs("CMS32", False)
    probe = AccuracyProbe()
    assert TService(ts, track_top=4, probe=probe,
                    device="cpu").probe is probe
    args = dict(track_top=4, device="cpu")
    args.update(kw)
    with pytest.raises(ValueError):
        TService(ts, **args)
