"""The port's untracked flush against the JAX package's (CPU).

Both packages get the same seeded numpy inputs:

  * threefry `split` on raw keys, bit for bit;
  * the one-shot `update_batched` past the one-shot table size (a CMS32
    table over 12 MiB), and `update_many` / `update_rows`, which switch
    to it there with split keys;
  * the plain versions of the dense and the row-mapped update kernels
    against the reference's interpret-mode Pallas kernels;
  * `ops.update_many` / `ops.update_rows` (with `uniform_rows`);
  * a `track_top=None` service: an epoch where every tenant is active in
    one fill class (one `update_many`), a skewed epoch (one `update_rows`
    per fill class), and the `dense=True` oracle.

Tolerance: none.  Cell states equal the reference's in every format: the
port's `nfold` is the reference's jitted float32 graph
(`core/xla_f32.py`), which its interpret-mode kernels and XLA engines
compile to.
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
from repro_torch import convert
from repro_torch.core import counters as tc
from repro_torch.core import prng
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sketch as tks
from repro_torch.stream import CountService as TService

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]


def _specs(name, packed=False, width=1024, depth=2):
    return (jsk.SketchSpec(width=width, depth=depth,
                           counter=getattr(jc, name), packed=packed),
            tsk.SketchSpec(width=width, depth=depth,
                           counter=getattr(tc, name), packed=packed))


def _cells_close(a: np.ndarray, b: np.ndarray, spec) -> None:
    """Storage tables equal, cell for cell."""
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _random_tables(rng, spec, lead):
    states = rng.integers(0, min(3000, spec.counter.max_state + 1),
                          lead + (spec.width,))
    if spec.packed:
        return np.array(jsk.storage_table(jnp.asarray(states, jnp.uint32),
                                          spec))
    return states.astype(np.asarray(jsk.init(spec).table).dtype)


# --------------------------------------------------------------------------
# threefry split, one-shot update past the limit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", [(0, 0), (5, 7), (0xFFFF_FFFF, 123)])
@pytest.mark.parametrize("num", [1, 3, 64])
def test_split_matches_jax(key, num):
    want = np.asarray(jax.random.split(np.asarray(key, np.uint32), num))
    got = prng.split(key, num)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# 1,638,400 CMS32 cells x depth 2 = 13.1 MB: past the 12 MiB limit
BIG = 1_638_400


def test_update_batched_past_one_shot_limit():
    js, ts = _specs("CMS32", width=BIG)
    assert ts.memory_bytes > tops.ONE_SHOT_UPDATE_TABLE_BYTES
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, 400, dtype=np.uint64).astype(np.uint32)
    keys[200:] = keys[:200]  # duplicates: dedup sums them
    w = rng.integers(1, 4, 400).astype(np.float32)
    key = np.asarray([9, 1], np.uint32)
    a = jsk.update_batched(jsk.init(js), jnp.asarray(keys), key,
                           weights=jnp.asarray(w))
    b = tsk.update_batched(tsk.init(ts, device="cpu"),
                           torch.from_numpy(keys.astype(np.int64)), key,
                           weights=torch.from_numpy(w))
    np.testing.assert_array_equal(tc.to_numpy(b.table), np.asarray(a.table))
    # the damped update (ported since the algebra slice) at this size
    a = jsk.update_batched(jsk.init(js), jnp.asarray(keys), key,
                           damp_alpha=0.5)
    b = tsk.update_batched(tsk.init(ts, device="cpu"),
                           torch.from_numpy(keys.astype(np.int64)), key,
                           damp_alpha=0.5)
    np.testing.assert_array_equal(tc.to_numpy(b.table), np.asarray(a.table))


def test_update_many_and_rows_switch_to_one_shot_past_limit():
    """Past the limit both ops take update_batched per row with split
    keys: the reference's algorithm, held exactly."""
    js, ts = _specs("CMS32", width=BIG)
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 5000, (2, 300)).astype(np.uint32)
    w = (rng.random((2, 300)) < 0.9).astype(np.float32)
    key = np.asarray([3, 4], np.uint32)
    tables = np.zeros((2, 2, BIG), np.uint32)
    want = np.asarray(jops.update_many(jnp.asarray(tables), js,
                                       jnp.asarray(keys), key,
                                       weights=jnp.asarray(w)))
    with tops.audit_scope() as tally:
        got = tops.update_many(tc.from_numpy(tables, "cpu"), ts, keys, key,
                               weights=torch.from_numpy(w))
    assert dict(tally) == {"update_many": 1}
    np.testing.assert_array_equal(tc.to_numpy(got), want)
    stack = np.zeros((3, 2, BIG), np.uint32)
    want = np.asarray(jops.update_rows(jnp.asarray(stack), js,
                                       jnp.asarray(keys), key, [2, 0],
                                       weights=jnp.asarray(w),
                                       uniform_rows=(5, [4, 1])))
    got = tops.update_rows(tc.from_numpy(stack, "cpu"), ts, keys, key,
                           [2, 0], weights=torch.from_numpy(w),
                           uniform_rows=(5, [4, 1]))
    np.testing.assert_array_equal(tc.to_numpy(got), want)


# --------------------------------------------------------------------------
# plain versions of kernels 5 and 6 against the Pallas kernels
# --------------------------------------------------------------------------

def _batch(rng, r, n):
    """Pre-deduplicated (R, N) batches with weight-0 stale slots."""
    raw = rng.integers(0, 3000, (r, n)).astype(np.uint32)
    w = np.ones((r, n), np.float32)
    w[:, -200:] = 0
    sk_, mult = jax.vmap(jsk.dedup_weighted)(jnp.asarray(raw),
                                             jnp.asarray(w))
    unif = rng.random((r, n)).astype(np.float32)
    return np.array(sk_), np.array(mult), unif


@pytest.mark.parametrize("name,packed", FORMATS)
def test_update_kernels_plain_match_pallas(name, packed):
    """The dense update's wrapper draws its uniforms from the flush key and
    grid (here a decoupled (5, N) grid at rows 1, 4, 2); the Pallas kernel
    is fed the reference's own draw of the same grid."""
    js, ts = _specs(name, packed)
    rng = np.random.default_rng(2)
    keys, mult, _ = _batch(rng, 3, 2300)  # three CHUNKs, the last short
    key, grid = np.asarray([9, 4], np.uint32), (5, np.asarray([1, 4, 2]))
    unif = np.array(jops._parity_uniforms(key, 2300, *grid))
    tables = _random_tables(rng, js, (5, 2))
    kw = dict(seeds=jops._seeds_tuple(js), width=js.width,
              counter=js.counter, interpret=True,
              cpl=js.cells_per_lane)
    want = np.asarray(jks.fused_update_pallas(
        jnp.asarray(tables[:3]), jnp.asarray(keys), jnp.asarray(mult),
        jnp.asarray(unif), **kw))
    tkw = dict(seeds=tops._seeds_tuple(ts), width=ts.width,
               counter=ts.counter, cpl=ts.cells_per_lane)
    t_keys = tc.from_numpy(keys, "cpu")
    got = tks.fused_update(tc.from_numpy(tables[:3], "cpu"), t_keys,
                           torch.from_numpy(mult), key, grid=grid, **tkw)
    _cells_close(tc.to_numpy(got), want, ts)
    rows = np.asarray([4, 0, 2], np.int32)
    want = np.asarray(jks.fused_update_rows_pallas(
        jnp.asarray(tables), jnp.asarray(keys), jnp.asarray(mult),
        jnp.asarray(unif), jnp.asarray(rows), **kw))
    got = tks.fused_update_rows(tc.from_numpy(tables, "cpu"), t_keys,
                                torch.from_numpy(mult),
                                torch.from_numpy(unif), rows, **tkw)
    _cells_close(tc.to_numpy(got), want, ts)
    np.testing.assert_array_equal(tc.to_numpy(got)[[1, 3]], tables[[1, 3]])
    with pytest.raises(ValueError, match="unique"):
        tks.fused_update_rows(got, t_keys, torch.from_numpy(mult),
                              torch.from_numpy(unif), [1, 1, 2], **tkw)


@pytest.mark.parametrize("name", ["CMS32", "CMLS8"])
def test_update_many_and_update_rows_match_jax(name):
    js, ts = _specs(name)
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2000, (3, 1500)).astype(np.uint32)
    w = (rng.random((3, 1500)) < 0.8).astype(np.float32)
    key = np.asarray([7, 2], np.uint32)
    tables = _random_tables(rng, js, (3, 2))
    want = np.asarray(jops.update_many(jnp.asarray(tables), js,
                                       jnp.asarray(keys), key,
                                       weights=jnp.asarray(w),
                                       uniform_rows=(6, [5, 0, 3])))
    got = tops.update_many(tc.from_numpy(tables, "cpu"), ts, keys, key,
                           weights=torch.from_numpy(w),
                           uniform_rows=(6, [5, 0, 3]))
    _cells_close(tc.to_numpy(got), want, ts)
    stack = _random_tables(rng, js, (7, 2))
    want = np.asarray(jops.update_rows(jnp.asarray(stack), js,
                                       jnp.asarray(keys[:2]), key, [6, 1],
                                       weights=jnp.asarray(w[:2])))
    with tops.audit_scope() as tally:
        got = tops.update_rows(tc.from_numpy(stack, "cpu"), ts, keys[:2],
                               key, [6, 1], weights=torch.from_numpy(w[:2]))
    assert dict(tally) == {"update_rows": 1}
    _cells_close(tc.to_numpy(got), want, ts)


def test_update_and_update_xla_match_jax():
    js, ts = _specs("CMLS16")
    keys = np.random.default_rng(4).zipf(1.3, 2500).astype(np.uint32)
    key = np.asarray([1, 1], np.uint32)
    a = jops.update(jsk.init(js), jnp.asarray(keys), key)
    b = tops.update(tsk.init(ts, device="cpu"), keys, key)
    _cells_close(tc.to_numpy(b.table), np.asarray(a.table), ts)
    c = tops.update_xla(tsk.init(ts, device="cpu"), keys, key)
    np.testing.assert_array_equal(tc.to_numpy(c.table),
                                  tc.to_numpy(b.table))


# --------------------------------------------------------------------------
# the untracked service
# --------------------------------------------------------------------------

NAMES = ["a", "b", "c", "d"]


def _pair(name, packed, cap=4096):
    js, ts = _specs(name, packed, width=512)
    a = JService(js, tenants=NAMES, queue_capacity=cap, seed=5)
    b = TService(ts, tenants=NAMES, queue_capacity=cap, seed=5, device="cpu")
    return a, b, ts


def _both(a, b, fn):
    with jops.audit_scope() as ta:
        fn(a)
    with tops.audit_scope() as tb:
        fn(b)
    assert dict(ta) == dict(tb)
    return dict(tb)


def _planes_close(a, b, spec):
    ta = jax.tree_util.tree_map(np.asarray, a._tree())
    meta, tb = convert.service_to_numpy(b)
    assert meta["track_top"] is None
    assert [p["rng_draws"] for p in a._meta()["planes"]] == \
        [p["rng_draws"] for p in meta["planes"]]
    for pa, pb in zip(ta["planes"], tb["planes"]):
        assert "topk" not in pa and "topk" not in pb
        for key in ("queue", "fill"):
            np.testing.assert_array_equal(pa[key], pb[key])
        _cells_close(pb["tables"], pa["tables"], spec)


def _epoch(rng, sizes):
    return {n: (rng.zipf(1.3, k) % 400 + i * 1000).astype(np.uint32)
            for i, (n, k) in enumerate(zip(NAMES, sizes)) if k}


@pytest.mark.parametrize("name,packed", [("CMS32", False),
                                         ("CMLS16", True)])
def test_untracked_epochs_match_jax(name, packed):
    """Uniform epoch -> one update_many; skewed epoch (two tenants, two
    fill classes) -> one update_rows per class; queries agree."""
    a, b, ts = _pair(name, packed)
    rng = np.random.default_rng(6)
    ev = _epoch(rng, [700, 800, 900, 1000])
    _both(a, b, lambda s: s.enqueue_many(ev))
    assert _both(a, b, lambda s: s.flush()) == {"update_many": 1}
    ev = _epoch(rng, [900, 0, 2500, 0])
    _both(a, b, lambda s: s.enqueue_many(ev))
    assert _both(a, b, lambda s: s.flush()) == {"update_rows": 2}
    _planes_close(a, b, ts)
    probes = np.arange(64, dtype=np.uint32)
    qa, qb = a.query_all(probes), b.query_all(probes)
    for n in NAMES:
        if name == "CMS32":
            np.testing.assert_array_equal(qb[n].numpy(), np.asarray(qa[n]))
    with pytest.raises(ValueError, match="tracking is off"):
        b.topk("a")


@pytest.mark.parametrize("regime", [[600, 600, 600, 600],
                                    [600, 0, 900, 0]])
def test_untracked_flush_equals_dense_oracle(regime):
    """With one fill class, the flush (all tenants: update_many; a subset:
    update_rows) lands exactly what the whole-plane `dense=True` flush
    lands (port against port: no tolerance).  Several fill classes draw
    their uniforms at their own widths, in the reference too, so they
    are held against the reference instead (test above)."""
    _, ts = _specs("CMLS8", width=512)
    svcs = [TService(ts, tenants=NAMES, queue_capacity=4096, seed=2,
                     device="cpu") for _ in range(2)]
    for svc in svcs:
        svc.enqueue_many(_epoch(np.random.default_rng(7), regime))
    svcs[0].flush()
    with tops.audit_scope() as tally:
        svcs[1].planes[0].flush(dense=True)
    assert dict(tally) == {"update_many": 1}
    assert torch.equal(tc.signed_view(svcs[0].planes[0].tables),
                       tc.signed_view(svcs[1].planes[0].tables))


def test_untracked_service_round_trips_through_convert():
    a, b, ts = _pair("CMS32", False)
    rng = np.random.default_rng(8)
    for sizes in ([300, 300, 300, 300], [100, 0, 2000, 0]):
        ev = _epoch(rng, sizes)
        _both(a, b, lambda s: s.enqueue_many(ev))
    meta = a._meta()
    tree = jax.tree_util.tree_map(np.asarray, a._tree())
    c = convert.service_from_numpy(meta, tree, device="cpu")
    assert c.track_top is None and c.planes[0].tracker is None
    _both(a, c, lambda s: s.flush())
    _planes_close(a, c, ts)
