"""The port's hot/cold tiering against the JAX package's, on the CPU.

Mirrors every test of `tests/test_tiering.py`: the same numpy streams from
a seed go through a tiered JAX service, a tiered port service and an
untiered port service (WIDTH = 256).  Within the port, tiered and
untiered must agree exactly: tables (`stacked_tables`), `query_all`,
`topk`.  Across the packages every leaf must agree: cell states, the
cold store, the queue and fill mirrors, the membership and the
estimates exactly, bit for bit in every format (the port computes the
reference's float32 graphs, `core/xla_f32.py`).  Also: the tier ops
(`tier_spill` with grid rows that are not `arange(C)`, `tier_query`,
`tier_demote`, `tier_promote`), `cold_advance` against
`ops.rotation_mask`, `plan_swap` under both
policies with ties, manifest v8 tiered snapshots both ways, the cold
store's repack, and a windowed `admit` on a cold tenant.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core import counters as jc
from repro.core import sharded as jsharded
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro.stream import CountService as JService
from repro.stream import TierSpec as JTierSpec
from repro.stream import WindowSpec as JWindowSpec
from repro.stream import tiering as jtiering
from repro.stream import window as jwin
from repro_torch import convert
from repro_torch.core import admission as tadm
from repro_torch.core import counters as tc
from repro_torch.core import sharded as tsharded
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.stream import CountService as TService
from repro_torch.stream import TierSpec as TTierSpec
from repro_torch.stream import WindowSpec as TWindowSpec
from repro_torch.stream import tier_memory_bytes
from repro_torch.stream import tiering as ttiering
from repro_torch.stream.service import _ColdLink as ColdLink
from repro_torch.stream import window as twin

WIDTH = 256
FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]


def _specs(name="CMLS16", packed=False, width=WIDTH):
    return (jsk.SketchSpec(width=width, depth=2, counter=getattr(jc, name),
                           packed=packed),
            tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                           packed=packed))


def _batch(rng, n=300, vocab=5_000):
    return (rng.zipf(1.3, n) % vocab).astype(np.uint32)


def _epoch_groups(regime: str, names, epochs: int):
    """Per-epoch active tenant groups of the three traffic regimes."""
    t = len(names)
    if regime == "uniform":
        return [list(names)] * epochs
    if regime == "hot1":
        return [[names[0]]] * epochs
    # churn: a 4-tenant working set shifting by 2 every epoch
    return [[names[(2 * e + i) % t] for i in range(4)]
            for e in range(epochs)]


def _services(names, hot, name="CMLS16", packed=False, track_top=8,
              cap=4096, policy="lru"):
    """(JAX tiered, port tiered, port untiered) services on one spec."""
    js, ts = _specs(name, packed)
    a = JService(js, tenants=names, queue_capacity=cap, seed=0,
                 track_top=track_top,
                 tier=JTierSpec(max_hot_tenants=hot, policy=policy))
    b = TService(ts, tenants=names, queue_capacity=cap, seed=0,
                 track_top=track_top,
                 tier=TTierSpec(max_hot_tenants=hot, policy=policy),
                 device="cpu")
    c = TService(ts, tenants=names, queue_capacity=cap, seed=0,
                 track_top=track_top, device="cpu")
    return a, b, c


def _drive(services, groups, seed=11, n=300):
    """Feed every service the same stream, flushing every epoch."""
    rng = np.random.default_rng(seed)
    for group in groups:
        events = {g: _batch(rng, n) for g in group}
        for s in services:
            s.enqueue_many(events)
            s.flush()


def _cells(x, spec):
    """Storage-layout tables -> int64 cell states."""
    x = np.asarray(x)
    if spec.packed:
        return np.asarray(jc.unpack_table(jnp.asarray(x),
                                          spec.counter.bits)).astype(np.int64)
    return x.astype(np.int64)


def _tnp(t: torch.Tensor) -> np.ndarray:
    return tc.to_numpy(t)


def _jax_tree(a):
    return jax.tree_util.tree_map(np.asarray, a._tree())


def _same_bits(got, want, err_msg=""):
    """Equal arrays; float32 ones bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, err_msg
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=err_msg)


def _assert_trees(ta, tb):
    """Every leaf of two services' checkpoint trees: same paths, shapes
    and dtypes, and equal (estimates bit for bit)."""
    fa = jax.tree_util.tree_flatten_with_path(ta)[0]
    fb = jax.tree_util.tree_flatten_with_path(tb)[0]
    assert [jax.tree_util.keystr(p) for p, _ in fa] == \
        [jax.tree_util.keystr(p) for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        where = jax.tree_util.keystr(path)
        _same_bits(y, x, err_msg=where)


def _assert_tier(ja, tb):
    """Membership, signals and host mirrors of one plane, both packages."""
    for key in ("slot", "slot_tenant", "last_active", "hits", "hfill",
                "hqueue"):
        np.testing.assert_array_equal(getattr(ja, key), getattr(tb, key),
                                      err_msg=key)
    assert ja.epoch == tb.epoch
    assert ja.cold.dtype == tb.cold.dtype
    np.testing.assert_array_equal(ja.cold, tb.cold)


def _assert_answers(a, b, c, names, k=5, probes=None, topk_names=None):
    """query_all and topk (of `topk_names`, default all): port tiered ==
    port untiered, and JAX tiered == port tiered, bit for bit."""
    probes = np.arange(32, dtype=np.uint32) if probes is None else probes
    qa, qb, qc = a.query_all(probes), b.query_all(probes), c.query_all(probes)
    for n in names:
        assert torch.equal(qb[n], qc[n]), n
        _same_bits(qb[n].numpy(), qa[n], err_msg=n)
    if b.track_top is None:
        return
    for n in names if topk_names is None else topk_names:
        ka, va = a.topk(n, k)
        kb, vb = b.topk(n, k)
        kc, vc = c.topk(n, k)
        assert np.array_equal(kb, kc) and np.array_equal(vb, vc), n
        np.testing.assert_array_equal(np.asarray(ka), kb)
        _same_bits(vb, va, err_msg=n)


def _assert_stacks(a, b, c, spec):
    for pa, pb, pc in zip(a.planes, b.planes, c.planes):
        sb = _tnp(pb.stacked_tables())
        np.testing.assert_array_equal(sb, _tnp(pc.tables))
        np.testing.assert_array_equal(_cells(pa.stacked_tables(), spec),
                                      _cells(sb, spec))


# --------------------------------------------------------------------------
# parity: JAX tiered == port tiered == port untiered
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tracked", [True, False],
                         ids=["tracked", "untracked"])
@pytest.mark.parametrize("regime", ["uniform", "hot1", "churn"])
def test_tiered_matches_resident(regime, tracked):
    """Everyone active (spill-heavy), one hot tenant (the fused path
    alone), a rotating working set (swaps every epoch): tables, tier
    state and answers agree across the packages and with the untiered
    port service."""
    names = [f"t{i}" for i in range(12)]
    a, b, c = _services(names, 4, track_top=8 if tracked else None)
    _drive((a, b, c), _epoch_groups(regime, names, 5))
    if regime == "churn":
        assert b.metrics.counter("tier_promotions",
                                 plane="p0").value > 0
    _assert_tier(a.planes[0].tier, b.planes[0].tier)
    _assert_stacks(a, b, c, _specs()[0])
    _assert_trees(_jax_tree(a), convert.service_to_numpy(b)[1])
    _assert_answers(a, b, c, names)
    assert b.tier_occupancy() == a.tier_occupancy()


@pytest.mark.parametrize("name", ["CMS32", "CMLS16", "CMLS8"],
                         ids=["cms32", "log16", "log8"])
def test_tiered_matches_resident_packed(name):
    """The cold store holds PACKED storage-layout rows: spill, demotion
    and promotion carry the packed lanes, in every packed format."""
    names = [f"t{i}" for i in range(6)]
    a, b, c = _services(names, 2, name=name, packed=True)
    _drive((a, b, c), _epoch_groups("churn", names, 4))
    assert b.planes[0].tier.cold.dtype == np.uint32
    _assert_tier(a.planes[0].tier, b.planes[0].tier)
    _assert_stacks(a, b, c, _specs(name, True)[0])
    _assert_answers(a, b, c, names)


def test_acceptance_128_tenants_8_hot():
    """max_hot_tenants=8 serving 128 tenants: occupancy, query_all and
    topk as the untiered port service; cells, tier state and query_all as
    the JAX tiered service.  The JAX service runs untracked here (its
    tracker grows by one compiled concatenation a tenant, about 10 s for
    128): a flush draws the same uniforms with or without tracking, so
    its tables are the tracked port service's."""
    names = [f"t{i:03d}" for i in range(128)]
    js, ts = _specs()
    a = JService(js, tenants=names, queue_capacity=2048, seed=0,
                 tier=JTierSpec(max_hot_tenants=8))
    b = TService(ts, tenants=names, queue_capacity=2048, seed=0,
                 track_top=8, tier=TTierSpec(max_hot_tenants=8),
                 device="cpu")
    c = TService(ts, tenants=names, queue_capacity=2048, seed=0,
                 track_top=8, device="cpu")
    groups = [[names[(17 * e + i) % 128] for i in range(24)]
              for e in range(3)]
    _drive((a, b, c), groups, seed=29, n=128)
    assert b.tier_occupancy()[b.planes[0].label] == {"hot": 8, "cold": 120}
    _assert_tier(a.planes[0].tier, b.planes[0].tier)
    _assert_stacks(a, b, c, js)
    probes = np.arange(16, dtype=np.uint32)
    qa, qb, qc = a.query_all(probes), b.query_all(probes), c.query_all(probes)
    for n in names:
        assert torch.equal(qb[n], qc[n])
        _same_bits(qb[n].numpy(), np.asarray(qa[n]))
    for n in names[:4] + names[40:44]:
        kb, vb = b.topk(n, 5)
        kc, vc = c.topk(n, 5)
        assert np.array_equal(kb, kc) and np.array_equal(vb, vc)


def test_demote_enqueue_promote_roundtrip():
    """A tenant demoted mid-stream keeps counting through the mirror and
    comes back as the untiered service has it: membership flips as the
    LRU plan says, two promotions and two demotions."""
    names = ["a", "b"]
    a, b, c = _services(names, 1, track_top=4)
    tier = b.planes[0].tier
    assert list(tier.slot) == [0, -1]
    _drive((a, b, c), [["a"], ["b"], ["b"], ["a", "b"], ["a"]], seed=5)
    assert list(tier.slot) == [0, -1]
    for s in (a, b):
        assert int(s.metrics.counter("tier_promotions",
                                     plane="p0").value) == 2
        assert int(s.metrics.counter("tier_demotions",
                                     plane="p0").value) == 2
    _assert_tier(a.planes[0].tier, tier)
    _assert_answers(a, b, c, names, k=4)


def test_tiered_dispatch_audit_matches_reference():
    """Per call, the port tallies what the reference tallies: an enqueue
    to a cold tenant nothing, a hot-only epoch {update_score_rows: 1}, a
    spill epoch + tier_spill, a swap epoch + tier_demote + tier_promote,
    a query_all query_many + tier_query."""
    names = [f"t{i}" for i in range(4)]
    a, b, _ = _services(names, 2, name="CMS32")
    rng = np.random.default_rng(3)
    tallies = []
    for group in (["t0", "t1"], ["t2"], ["t0", "t1", "t2"], ["t1", "t2"]):
        events = {g: _batch(rng) for g in group}
        got = []
        for s, o in ((a, jops), (b, tops)):
            with o.audit_scope() as t1:
                s.enqueue_many(events)
            with o.audit_scope() as t2:
                s.flush()
            got.append((dict(t1), dict(t2)))
        assert got[0] == got[1]
        tallies.append(got[1])
    # t2 (cold) takes t0's slot; then a spill beside the hot flush with no
    # idle victim, then a hot-only epoch
    assert tallies == [
        ({"queue_append": 1}, {"update_score_rows": 1}),
        ({}, {"tier_spill": 1, "tier_demote": 1, "tier_promote": 1}),
        ({"queue_append": 1}, {"update_score_rows": 1, "tier_spill": 1}),
        ({"queue_append": 1}, {"update_score_rows": 1})]
    probes = np.arange(8, dtype=np.uint32)
    with jops.audit_scope() as ta:
        a.query_all(probes)
    with tops.audit_scope() as tb:
        b.query_all(probes)
    assert dict(ta) == dict(tb) == {"query_many": 1, "tier_query": 1}


def test_windowed_tiered_matches_resident_mid_rotation():
    """Windowed tenants demote their whole (B, d, w) ring: rotations
    land on hot rings through the masked device zeroing and on cold rings
    through `cold_advance`, so answers agree across tiers and packages
    even when a swap lands mid-rotation."""
    js, ts = _specs()
    names = [f"w{i}" for i in range(6)]
    a = JService(queue_capacity=4096, seed=0, track_top=8,
                 tier=JTierSpec(max_hot_tenants=2))
    b = TService(queue_capacity=4096, seed=0, track_top=8,
                 tier=TTierSpec(max_hot_tenants=2), device="cpu")
    c = TService(queue_capacity=4096, seed=0, track_top=8, device="cpu")
    jw = JWindowSpec(sketch=js, buckets=4, interval=60.0)
    tw = TWindowSpec(sketch=ts, buckets=4, interval=60.0)
    for n in names:
        a.add_tenant(n, window=jw)
        b.add_tenant(n, window=tw)
        c.add_tenant(n, window=tw)
    rng = np.random.default_rng(13)
    ts_ = 10.0
    for e in range(5):
        group = [names[(2 * e + i) % 6] for i in range(3)]
        ts_ += 45.0  # crosses an interval boundary every other epoch
        for n in group:
            keys = _batch(rng)
            for s in (a, b, c):
                s.enqueue(n, keys, ts=ts_)
        for s in (a, b, c):
            s.flush()
    assert b.metrics.counter("tier_promotions", plane="w0").value > 0
    _assert_tier(a.planes[0].tier, b.planes[0].tier)
    np.testing.assert_array_equal(_tnp(b.planes[0].stacked_tables()),
                                  _tnp(c.planes[0].tables))
    _assert_trees(_jax_tree(a), convert.service_to_numpy(b)[1])
    probes = np.arange(32, dtype=np.uint32)
    for n in names:
        for kw in ({}, {"n_buckets": 2}, {"mode": "max"}, {"gamma": 0.9}):
            qb, qc = b.query(n, probes, **kw), c.query(n, probes, **kw)
            assert torch.equal(qb, qc), (n, kw)
            _same_bits(qb.numpy(), np.asarray(a.query(n, probes, **kw)))
        kb, vb = b.topk(n, 4)
        kc, vc = c.topk(n, 4)
        assert np.array_equal(kb, kc) and np.array_equal(vb, vc)
        ka, va = a.topk(n, 4)
        np.testing.assert_array_equal(np.asarray(ka), kb)
        _same_bits(vb, va)
    qa, qb, qc = (s.query_all(probes) for s in (a, b, c))
    for n in names:
        assert torch.equal(qb[n], qc[n])
        _same_bits(qb[n].numpy(), np.asarray(qa[n]))


def test_windowed_admit_on_cold_tenant():
    """A windowed `admit` on a cold tenant re-scores its heap on the
    uploaded ring: the same rows and mask as the untiered port service
    and the JAX tiered service (CMS32: exact estimates)."""
    js, ts = _specs("CMS32")
    jasp = jadm.AdmissionSpec(threshold=3.0, n_fallback=16, table_rows=256)
    tasp = tadm.AdmissionSpec(threshold=3.0, n_fallback=16, table_rows=256)
    names = [f"w{i}" for i in range(4)]
    a = JService(queue_capacity=1024, seed=0, track_top=8,
                 tier=JTierSpec(max_hot_tenants=1))
    b = TService(queue_capacity=1024, seed=0, track_top=8,
                 tier=TTierSpec(max_hot_tenants=1), device="cpu")
    c = TService(queue_capacity=1024, seed=0, track_top=8, device="cpu")
    jw = JWindowSpec(sketch=js, buckets=4, interval=60.0)
    tw = TWindowSpec(sketch=ts, buckets=4, interval=60.0)
    for n in names:
        a.add_tenant(n, window=jw, admission=jasp)
        b.add_tenant(n, window=tw, admission=tasp)
        c.add_tenant(n, window=tw, admission=tasp)
    rng = np.random.default_rng(17)
    for e in range(3):
        events = {n: _batch(rng, 200, 50) for n in names}
        for s in (a, b, c):
            s.enqueue_many(events, ts=30.0 + 70.0 * e)
    cold = [n for n in names if b.planes[0].tier.slot[names.index(n)] < 0]
    assert cold
    ids = np.arange(64, dtype=np.uint32)
    for n in cold:
        for kw in ({}, {"n_buckets": 2}, {"gamma": 0.5}):
            rb, mb = b.admit(n, ids, **kw)
            rc, mc = c.admit(n, ids, **kw)
            ra, ma = a.admit(n, ids, **kw)
            assert torch.equal(rb, rc) and torch.equal(mb, mc)
            np.testing.assert_array_equal(np.asarray(ra), rb.numpy())
            np.testing.assert_array_equal(np.asarray(ma), mb.numpy())
        assert bool(mb.any())


# --------------------------------------------------------------------------
# checkpoint manifest v8, both ways
# --------------------------------------------------------------------------

def _tiered_pair_stream(names, hot):
    js, ts = _specs()
    a = JService(js, tenants=names, queue_capacity=4096, seed=0,
                 track_top=8, tier=JTierSpec(max_hot_tenants=hot))
    b = TService(ts, tenants=names, queue_capacity=4096, seed=0,
                 track_top=8, tier=TTierSpec(max_hot_tenants=hot),
                 device="cpu")
    rng = np.random.default_rng(7)
    for e in range(4):
        events = {names[(2 * e + i) % len(names)]: _batch(rng)
                  for i in range(4)}
        for s in (a, b):
            s.enqueue_many(events)
            s.flush()
    events = {names[5]: _batch(rng)}  # pending ring events ride too
    for s in (a, b):
        s.enqueue_many(events)
    return a, b


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_manifest_v8_tiered_both_ways(direction, tmp_path):
    """A tiered snapshot written by one package restores into the other:
    the same membership, leaf names, shapes and dtypes, the same answers,
    and the same behavior through the next swap epoch."""
    names = [f"t{i}" for i in range(9)]
    a, b = _tiered_pair_stream(names, 3)
    if direction == "jax_to_port":
        a.snapshot(str(tmp_path), step=3)
        src, dst = a, TService.restore(str(tmp_path), device="cpu")
        src_tree, dst_tree = _jax_tree(src), convert.service_to_numpy(dst)[1]
        jt, tt = src.planes[0].tier, dst.planes[0].tier
    else:
        b.snapshot(str(tmp_path), step=3)
        src, dst = b, JService.restore(str(tmp_path))
        src_tree, dst_tree = convert.service_to_numpy(src)[1], _jax_tree(dst)
        jt, tt = dst.planes[0].tier, src.planes[0].tier
    assert dst._meta()["version"] == 8
    assert dst._meta()["tier"] == {"max_hot_tenants": 3, "policy": "lru"}
    assert dst._meta()["planes"] == src._meta()["planes"]
    _assert_tier(jt, tt)
    _assert_trees(src_tree, dst_tree)
    probes = np.arange(32, dtype=np.uint32)
    for step in range(2):
        qs, qd = src.query_all(probes), dst.query_all(probes)
        for n in names:
            _same_bits(np.asarray(qs[n]), np.asarray(qd[n]))
        for s in (src, dst):
            s.enqueue_many({names[8]: np.arange(64, dtype=np.uint32)})
            s.flush()
    jt, tt = ((src, dst) if direction == "jax_to_port" else (dst, src))
    _assert_tier(jt.planes[0].tier, tt.planes[0].tier)


def test_restore_repacks_cold_store(tmp_path):
    """`restore(packed=...)` converts the host cold store with the device
    tables, cell for cell: answers are unchanged for hot and cold tenants
    alike, and equal the JAX package's repacked restore."""
    names = [f"t{i}" for i in range(6)]
    js, ts = _specs("CMS32")
    b = TService(ts, tenants=names, queue_capacity=4096, seed=0,
                 tier=TTierSpec(max_hot_tenants=2), device="cpu")
    rng = np.random.default_rng(19)
    b.enqueue_many({n: _batch(rng) for n in names})
    b.flush()
    b.snapshot(str(tmp_path), step=1)
    b2 = TService.restore(str(tmp_path), packed=True, device="cpu")
    a2 = JService.restore(str(tmp_path), packed=True)
    assert b2.planes[0].spec.packed and b2.planes[0].tier.cold.dtype \
        == np.uint32
    np.testing.assert_array_equal(a2.planes[0].tier.cold,
                                  b2.planes[0].tier.cold)
    probes = np.arange(32, dtype=np.uint32)
    q, q2, qa = b.query_all(probes), b2.query_all(probes), \
        a2.query_all(probes)
    for n in names:
        assert torch.equal(q[n], q2[n])
        np.testing.assert_array_equal(np.asarray(qa[n]), q2[n].numpy())
    back = TService.restore(str(tmp_path), packed=False, device="cpu")
    np.testing.assert_array_equal(back.planes[0].tier.cold,
                                  b.planes[0].tier.cold)


# --------------------------------------------------------------------------
# per-row flush trim
# --------------------------------------------------------------------------

def test_fill_classes_groups_by_own_rounded_fill():
    fill = np.array([100, 3000, 512, 1025, 0])
    rows = np.array([0, 1, 2, 3])
    for cap, f, r in ((8 * tops.CHUNK, fill, rows),
                      (4096, np.array([900, 1000]), np.array([0, 1])),
                      (2048, np.array([3000]), np.array([0])),
                      (4096, fill, np.array([], np.int64))):
        got = ttiering.fill_classes(f, r, cap)
        want = jtiering.fill_classes(f, r, cap)
        assert [(c, list(x)) for c, x in got] == \
            [(c, list(x)) for c, x in want]
    assert [(c, list(x)) for c, x in ttiering.fill_classes(
        fill, rows, 8 * tops.CHUNK)] == [(1024, [0, 2]), (2048, [3]),
                                         (3072, [1])]


def test_tiered_flush_trims_per_row_not_batch_max(monkeypatch):
    """Skewed fills (100 and 3000 keys) on hot tenants gather each class
    at its OWN rounded width, as the reference does."""
    seen = []
    orig = tops.flush_rows_inputs

    def spy(queue, fill, rows, cols):
        keys, weights = orig(queue, fill, rows, cols)
        seen.append((int(cols), tuple(keys.shape)))
        return keys, weights

    monkeypatch.setattr(tops, "flush_rows_inputs", spy)
    _, ts = _specs()
    svc = TService(ts, tenants=["a", "b"], queue_capacity=4096, seed=0,
                   tier=TTierSpec(max_hot_tenants=2), device="cpu")
    svc.enqueue("a", np.arange(100, dtype=np.uint32))
    svc.enqueue("b", np.arange(3000, dtype=np.uint32))
    with tops.audit_scope() as tally:
        svc.flush()
    assert seen == [(1024, (1, 1024)), (3072, (1, 3072))]
    assert dict(tally) == {"update_rows": 2}


# --------------------------------------------------------------------------
# sizing, assembly, validation, the host-side pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("packed,frac", [(False, 0.5), (True, 0.25)])
def test_from_memory_splits_budget_across_tiers(packed, frac):
    budget = 1 << 20
    jspec, jts = jtiering.from_memory(budget, max_hot_tenants=8,
                                      hot_fraction=frac, packed=packed)
    spec, tspec = ttiering.from_memory(budget, max_hot_tenants=8,
                                       hot_fraction=frac, packed=packed)
    assert (spec.width, spec.depth, spec.packed) == \
        (jspec.width, jspec.depth, jspec.packed)
    assert (tspec.max_hot_tenants, tspec.policy) == \
        (jts.max_hot_tenants, jts.policy)
    assert 8 * spec.memory_bytes <= int(budget * frac)
    for tenants in (3, 128):
        assert tier_memory_bytes(spec, tspec, tenants) == \
            jtiering.tier_memory_bytes(jspec, jts, tenants)
    assert tier_memory_bytes(spec, tspec, 3) == {
        "hot": 3 * spec.memory_bytes, "cold": 0,
        "total": 3 * spec.memory_bytes}


def test_from_memory_validates_hot_fraction():
    for frac in (0.0, 1.5):
        with pytest.raises(ValueError, match="hot_fraction"):
            ttiering.from_memory(1 << 20, max_hot_tenants=4,
                                 hot_fraction=frac)


def test_tier_assemble_rebuilds_resident_stack():
    """`stacked_tables` copies the hot stack into the cold copy at the
    slot->tenant map: equal to the untiered plane's stack and to the JAX
    package's `tier_assemble`."""
    names = [f"t{i}" for i in range(7)]
    a, b, c = _services(names, 3, name="CMS32", track_top=None)
    _drive((a, b, c), _epoch_groups("churn", names, 4))
    t = b.planes[0].tier
    np.testing.assert_array_equal(_tnp(b.planes[0].stacked_tables()),
                                  _tnp(c.planes[0].tables))
    link = b.planes[0]._link
    out = tsharded.tier_assemble(b.planes[0].tables, t.slot_tenant,
                                 link.up(t.cold))
    np.testing.assert_array_equal(_tnp(out), _tnp(c.planes[0].tables))
    ja = a.planes[0]
    np.testing.assert_array_equal(np.asarray(jsharded.tier_assemble(
        ja.tables, ja.tier.slot_tenant, ja.tier.cold)), _tnp(out))
    empty = tsharded.tier_assemble(b.planes[0].tables[:0], [],
                                   link.up(t.cold))
    np.testing.assert_array_equal(_tnp(empty), t.cold)


@pytest.mark.parametrize("kw", [dict(max_hot_tenants=0),
                                dict(max_hot_tenants=2, policy="random")],
                         ids=["no_slots", "bad_policy"])
def test_tierspec_validation(kw):
    with pytest.raises(ValueError) as te:
        TTierSpec(**kw)
    with pytest.raises(ValueError) as je:
        JTierSpec(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("steps", range(6))
def test_cold_advance_clears_what_rotation_mask_clears(steps):
    """For B = 4 and every cursor: the buckets `cold_advance` zeroes (in
    place) are exactly `ops.rotation_mask`'s, the others untouched, as
    the JAX package's `cold_advance` gives them."""
    b = 4
    rng = np.random.default_rng(steps)
    ring = rng.integers(1, 60_000, (b, 2, 16)).astype(np.uint16)
    for cursor in range(b):
        mine = ring.copy()
        got = twin.cold_advance(mine, cursor, steps)
        assert got is mine  # in place
        mask = tops.rotation_mask([cursor], [steps], b)[0]
        assert np.all(got[mask] == 0)
        np.testing.assert_array_equal(got[~mask], ring[~mask])
        np.testing.assert_array_equal(got, jwin.cold_advance(ring, cursor,
                                                             steps))
        assert mask.sum() == min(steps, b)


def _planetier(mod, policy):
    """A 10-tenant PlaneTier with 5 slots, a just-landed epoch with three
    active cold tenants, and victims tied on both signals."""
    spec = mod.TierSpec(max_hot_tenants=5, policy=policy)
    t = mod.PlaneTier(spec, (2, 8), np.uint16, 256)
    for _ in range(10):
        t.add_row()
    t.epoch = 6
    t.last_active[:] = [2, 5, 2, 4, 2, 5, 5, 1, 5, 3]
    t.hits[:] = [3, 4, 1, 1, 3, 2, 6, 0, 2, 9]
    return t


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_plan_swap_orders_victims_and_candidates(policy):
    """Victims ordered by the policy with ties broken by tenant row, the
    most frequent candidates first, as the JAX package plans them; the
    swap and the membership after it agree."""
    tt, jt = _planetier(ttiering, policy), _planetier(jtiering, policy)
    dt, pt = tt.plan_swap()
    dj, pj = jt.plan_swap()
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(pt, pj)
    # cold tenants 5, 6, 8 were active in epoch 5; hot 0-4 idle in it
    assert sorted(pt.tolist()) == [5, 6, 8] and pt.tolist()[0] == 6
    want = {"lru": [2, 0, 4], "lfu": [2, 3, 0]}[policy]
    assert dt.tolist() == want
    tt.swap(dt, pt)
    jt.swap(dj, pj)
    np.testing.assert_array_equal(tt.slot, jt.slot)
    np.testing.assert_array_equal(tt.slot_tenant, jt.slot_tenant)


# --------------------------------------------------------------------------
# the tier ops against the JAX package's
# --------------------------------------------------------------------------

def _spill_inputs(spec_name, packed, seed=23):
    js, ts = _specs(spec_name, packed)
    rng = np.random.default_rng(seed)
    c, n = 3, 1536
    total, urows = 7, np.array([5, 1, 3])
    cells = rng.integers(0, 3, (c, 2, WIDTH))
    if packed:
        stack = np.array(jsk.storage_table(jnp.asarray(cells, jnp.uint32),
                                           js))
    else:
        stack = cells.astype(np.asarray(jsk.init(js).table).dtype)
    keys = (rng.zipf(1.3, (c, n)) % 400).astype(np.uint32)
    weights = (np.arange(n)[None, :] < np.array([[1536], [700], [1100]])
               ).astype(np.float32)
    cand = (rng.zipf(1.3, (c, 40)) % 400).astype(np.uint32)
    key = np.asarray([4, 9], np.uint32)
    return js, ts, stack, keys, weights, cand, key, (total, urows)


@pytest.mark.parametrize("scored", [True, False], ids=["cand", "no_cand"])
@pytest.mark.parametrize("fmt", FORMATS,
                         ids=[f"{n}{'-packed' if p else ''}"
                              for n, p in FORMATS])
def test_tier_spill_matches_reference(fmt, scored):
    """`tier_spill` on a stack whose grid rows are not arange(C): the
    cells the JAX package's spill lands (its XLA reference engine), and
    with candidates their scores."""
    js, ts, stack, keys, weights, cand, key, grid = _spill_inputs(*fmt)
    kw = dict(cand=jnp.asarray(cand)) if scored else {}
    want = jops.tier_spill(jnp.asarray(stack), js, jnp.asarray(keys), key,
                           jnp.asarray(weights), grid, **kw)
    tab = tc.from_numpy(stack, "cpu")
    with tops.audit_scope() as tally:
        got = tops.tier_spill(tab, ts, keys, key, torch.from_numpy(weights),
                              grid, cand=cand if scored else None)
    assert dict(tally) == {"tier_spill": 1}
    plain = tops.tier_spill(tc.from_numpy(stack, "cpu"), ts, keys, key,
                            torch.from_numpy(weights), grid,
                            cand=cand if scored else None, engine="plain")
    if scored:
        (want, west), (got, gest), (plain, pest) = want, got, plain
        assert torch.equal(gest, pest)
        _same_bits(gest.numpy(), np.asarray(west))
    assert got is tab  # in place
    assert torch.equal(tc.signed_view(got), tc.signed_view(plain))
    np.testing.assert_array_equal(_cells(_tnp(got), js),
                                  _cells(want, js))


def test_tier_query_matches_reference():
    js, ts, stack, keys, _, _, _, _ = _spill_inputs("CMLS16", True)
    probes = keys[:, :64]
    want = jops.tier_query(jnp.asarray(stack), js, jnp.asarray(probes))
    got = tops.tier_query(tc.from_numpy(stack, "cpu"), ts, probes)
    _same_bits(got.numpy(), np.asarray(want))
    shared = tops.tier_query(tc.from_numpy(stack, "cpu"), ts, probes[0])
    assert torch.equal(shared[1], tops.tier_query(
        tc.from_numpy(stack[1:2], "cpu"), ts, probes[0])[0])
    with pytest.raises(ValueError, match="rows"):
        tops.tier_query(tc.from_numpy(stack, "cpu"), ts, probes[:2])


def test_tier_demote_and_promote():
    """Demotion gathers slots out of the hot stack; promotion writes
    tables and ring rows in place at the slots, one op tally each."""
    rng = np.random.default_rng(2)
    hot = rng.integers(0, 60_000, (4, 2, 16)).astype(np.uint16)
    ring = rng.integers(0, 2**32, (4, 128), dtype=np.uint64).astype(
        np.uint32)
    tab, q = tc.from_numpy(hot, "cpu"), tc.from_numpy(ring, "cpu")
    with tops.audit_scope() as tally:
        out = tops.tier_demote(tab, [3, 1])
        new_t = rng.integers(0, 60_000, (2, 2, 16)).astype(np.uint16)
        new_q = rng.integers(0, 2**32, (2, 128), dtype=np.uint64).astype(
            np.uint32)
        t2, q2 = tops.tier_promote(tab, q, [3, 1], tc.from_numpy(new_t, "cpu"),
                                   tc.from_numpy(new_q, "cpu"))
    assert dict(tally) == {"tier_demote": 1, "tier_promote": 1}
    np.testing.assert_array_equal(_tnp(out), hot[[3, 1]])
    assert t2 is tab and q2 is q
    want_t, want_q = hot.copy(), ring.copy()
    want_t[[3, 1]], want_q[[3, 1]] = new_t, new_q
    np.testing.assert_array_equal(_tnp(tab), want_t)
    np.testing.assert_array_equal(_tnp(q), want_q)


def test_tier_state_rides_convert_both_ways():
    """`convert.service_from_numpy` of a JAX tiered service's state gives
    a port service holding the same leaves and membership, and
    `service_to_numpy` gives them back; both then answer alike."""
    names = [f"t{i}" for i in range(9)]
    a, _ = _tiered_pair_stream(names, 3)
    meta = a._meta()
    b = convert.service_from_numpy(meta, _jax_tree(a), device="cpu")
    meta_b, tree_b = convert.service_to_numpy(b)
    assert meta_b["planes"] == meta["planes"] and meta_b["tier"] == \
        meta["tier"]
    _assert_trees(_jax_tree(a), tree_b)
    _assert_tier(a.planes[0].tier, b.planes[0].tier)
    probes = np.arange(16, dtype=np.uint32)
    qa, qb = a.query_all(probes), b.query_all(probes)
    for n in names:
        _same_bits(qb[n].numpy(), np.asarray(qa[n]))
    meta_b, tree_b = convert.service_to_numpy(b)  # after the flushing read
    c = convert.service_from_numpy(meta_b, tree_b, device="cpu")
    _assert_trees(convert.service_to_numpy(c)[1], tree_b)
    # the state was copied, not shared: b moves on, c stays
    b.enqueue_many({names[0]: np.arange(8, dtype=np.uint32)})
    assert b.planes[0].tier.hfill[0] == 8 and c.planes[0].tier.hfill[0] == 0


def test_tiered_dense_flush_raises():
    _, ts = _specs()
    svc = TService(ts, tenants=["a", "b"], tier=TTierSpec(1), device="cpu")
    svc.enqueue("a", np.arange(4, dtype=np.uint32))
    with pytest.raises(ValueError, match="dense"):
        svc.planes[0].flush(dense=True)
    assert dataclasses.asdict(svc.tier) == {"max_hot_tenants": 1,
                                            "policy": "lru"}


def _link_src():
    src = np.random.default_rng(0).integers(0, 1 << 16, (9, 2, 16),
                                             dtype=np.uint16)
    return ColdLink(torch.device("cpu")), src


@pytest.mark.parametrize("slot_bytes", [1, 3 * 2 * 16 * 2, 1 << 20],
                         ids=["one_row", "three_rows", "whole"])
def test_cold_link_moves_rows_in_bounded_chunks(slot_bytes):
    """A tiered plane's cold link moves rows through host slots of at most
    SLOT_BYTES (or one row, when a row is larger), whatever the size of
    the store: the upload equals the plain gather and the read-back lands
    in exactly the named rows."""
    link, src = _link_src()
    link.SLOT_BYTES = slot_bytes
    rows = np.array([7, 0, 3, 3, 8])
    np.testing.assert_array_equal(_tnp(link.up(src, rows)), src[rows])
    np.testing.assert_array_equal(_tnp(link.up(src)), src)
    row_bytes = src[0].nbytes
    assert max(h.numel() for h in link._staging.host) <= max(slot_bytes,
                                                             row_bytes)
    dst = np.zeros_like(src)
    back = np.array([8, 1, 4])
    link.down(link.up(src, back), dst, back)
    np.testing.assert_array_equal(dst[back], src[back])
    assert not dst[np.setdiff1d(np.arange(9), back)].any()
    assert link.pinned_bytes == 0  # CPU: plain slots


@pytest.mark.parametrize("rows", [[-1], [9], [0, 12]],
                         ids=["cold_slot", "past_end", "one_stale"])
def test_cold_link_rejects_rows_outside_the_store(rows):
    """A row outside the host array (a cold tenant's slot -1, a stale row)
    raises, rather than moving another tenant's table."""
    link, src = _link_src()
    with pytest.raises(IndexError, match="outside"):
        link.up(src, rows)
    with pytest.raises(IndexError, match="outside"):
        link.down(torch.from_numpy(src[:len(rows)].copy()), src, rows)
