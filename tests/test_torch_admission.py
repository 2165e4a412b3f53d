"""The port's admission plane against the JAX package's (CPU).

Both packages get the same seeded numpy inputs:

  * `rows_of`, `admit` (sketch-thresholded), `admit_tracked` (from a
    tracker row), and `observe_and_admit` on a batch of more than 1,024
    distinct ids (several update chunks) with the reference's "xla" and
    "kernel" (interpret-mode Pallas) engines against the port's "xla" and
    "auto" (the plain engine on a CPU table);
  * the service's tracker-fed `admit`, plain and windowed: promotion from
    one flush epoch to the next, expiry out of the window, `n_buckets`,
    `gamma`, and the reference's ValueError / TypeError cases.

Tolerance: none.  Rows, tables, estimates and decisions are exact in
every format, an estimate at the threshold included: the port computes
the reference's float32 graphs (`core/xla_f32.py`), the eager decode
where the reference's `admit` queries op by op and the jitted one on its
kernel engine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core import counters as jc
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro.stream import CountService as JService
from repro.stream import WindowSpec as JWindowSpec
from repro_torch.core import admission as tadm
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.stream import CountService as TService
from repro_torch.stream import WindowSpec as TWindowSpec

JASPEC = jadm.AdmissionSpec(threshold=5.0, n_fallback=64, table_rows=1024)
TASPEC = tadm.AdmissionSpec(threshold=5.0, n_fallback=64, table_rows=1024)


def _specs(name, width=4096, depth=3, packed=False):
    return (jsk.SketchSpec(width=width, depth=depth,
                           counter=getattr(jc, name), packed=packed),
            tsk.SketchSpec(width=width, depth=depth,
                           counter=getattr(tc, name), packed=packed))


def _zipf(n, vocab, seed=0):
    return (np.random.default_rng(seed).zipf(1.3, n) % vocab).astype(
        np.uint32)


def _equal(rows_mask_a, rows_mask_b):
    (ra, ma), (rb, mb) = rows_mask_a, rows_mask_b
    np.testing.assert_array_equal(np.asarray(ra), rb.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(ma), mb.cpu().numpy())
    assert rb.dtype == torch.int32 and mb.dtype == torch.bool


# --------------------------------------------------------------------------
# core/admission
# --------------------------------------------------------------------------

def test_admission_spec_fields_match_the_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(tadm.AdmissionSpec)] == \
        [f.name for f in dataclasses.fields(jadm.AdmissionSpec)]
    assert dataclasses.asdict(tadm.AdmissionSpec()) == \
        dataclasses.asdict(jadm.AdmissionSpec())


@pytest.mark.parametrize("n_fallback,table_rows", [(64, 1024), (1024, 1 << 16),
                                                   (7, 1 << 20)])
def test_rows_of_matches_jax(n_fallback, table_rows):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    ids[:3] = [0, 0xFFFF_FFFF, 0xC01D]
    mask = rng.random(4000) < 0.5
    js = jadm.AdmissionSpec(threshold=1.0, n_fallback=n_fallback,
                            table_rows=table_rows)
    ts = tadm.AdmissionSpec(threshold=1.0, n_fallback=n_fallback,
                            table_rows=table_rows)
    want = jadm.rows_of(jnp.asarray(ids), jnp.asarray(mask), js)
    got = tadm.rows_of(tc.from_numpy(ids, "cpu"), torch.from_numpy(mask), ts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", ["CMS32", "CMLS16", "CMLS8"])
def test_admit_against_a_sketch_matches_jax(name):
    js, ts = _specs(name, width=2048)
    events = _zipf(6000, 500, seed=2)
    a = jsk.update_batched(jsk.init(js), jnp.asarray(events),
                           np.asarray([0, 9], np.uint32))
    b = tsk.Sketch(table=tc.from_numpy(np.asarray(a.table), "cpu"), spec=ts)
    ids = np.arange(600, dtype=np.uint32)
    _equal(jadm.admit(a, jnp.asarray(ids), JASPEC),
           tadm.admit(b, ids, TASPEC))


def test_admit_tracked_matches_jax():
    rng = np.random.default_rng(3)
    k = 32
    keys = rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 0xFFFF_FFFF, 7, 7]
    est = rng.uniform(0, 12, k).astype(np.float32)
    est[4] = 5.0  # exactly the threshold: admitted
    filled = rng.random(k) < 0.8
    filled[0] = False  # an unfilled key-0 slot never admits
    ids = np.concatenate([keys, rng.integers(0, 2**32, 200, dtype=np.uint64)
                          .astype(np.uint32), [0, 7]]).astype(np.uint32)
    want = jadm.admit_tracked(jnp.asarray(keys), jnp.asarray(est),
                              jnp.asarray(filled), jnp.asarray(ids), JASPEC)
    got = tadm.admit_tracked(tc.from_numpy(keys, "cpu"),
                             torch.from_numpy(est), torch.from_numpy(filled),
                             ids, TASPEC)
    _equal(want, got)
    assert bool(got[1][4]) and not bool(got[1][-2])
    with pytest.raises(ValueError):
        tadm.admit_tracked(tc.from_numpy(keys, "cpu"), torch.from_numpy(est),
                           torch.from_numpy(filled), ids.reshape(2, -1),
                           TASPEC)


@pytest.mark.parametrize("name", ["CMS32", "CMLS16"])
def test_observe_and_admit_engines_match_jax(name):
    """A batch of more than one update chunk of distinct ids, where later
    chunks see earlier chunks' writes: the reference's two engines and
    the port's two give the same table, rows and mask."""
    js, ts = _specs(name, width=2048)
    ids = np.random.default_rng(2).integers(0, 4000, 6000).astype(np.uint32)
    assert len(np.unique(ids)) > 1024
    key = np.asarray([0, 4], np.uint32)
    want = {}
    for engine in ("xla", "kernel"):
        s, rows, mask = jadm.observe_and_admit(jsk.init(js), jnp.asarray(ids),
                                               key, JASPEC, engine=engine)
        want[engine] = (np.asarray(s.table), np.asarray(rows),
                        np.asarray(mask))
    for engine in ("xla", "kernel"):
        for x, y in zip(want["xla"], want[engine]):
            np.testing.assert_array_equal(x, y)
    for engine in ("xla", "auto"):
        with tops.audit_scope() as tally:
            s, rows, mask = tadm.observe_and_admit(
                tsk.init(ts, device="cpu"), ids, key, TASPEC, engine=engine)
        assert dict(tally) == {"update": 1}
        np.testing.assert_array_equal(tc.to_numpy(s.table), want["xla"][0])
        np.testing.assert_array_equal(rows.numpy(), want["xla"][1])
        np.testing.assert_array_equal(mask.numpy(), want["xla"][2])


def test_update_chunked_past_one_shot_size_equals_jax_update_xla():
    """Past `ONE_SHOT_UPDATE_TABLE_BYTES` `ops.update` switches to the
    one-shot update, but `ops.update_chunked` (what `observe_and_admit`'s
    kernel engine runs on the card) stays the CHUNK-sequential update
    the reference's `update_xla` computes: tables exactly equal."""
    js, ts = _specs("CMS32", width=1 << 21, depth=2)
    assert ts.memory_bytes > tops.ONE_SHOT_UPDATE_TABLE_BYTES
    ids = np.random.default_rng(3).integers(0, 1 << 30, 3000).astype(
        np.uint32)
    key = np.asarray([0, 9], np.uint32)
    want = jops.update_xla(jsk.init(js), jnp.asarray(ids), key)
    got = tops.update_chunked(tsk.init(ts, device="cpu"), ids, key)
    np.testing.assert_array_equal(tc.to_numpy(got.table),
                                  np.asarray(want.table))


def test_observe_and_admit_validates_ids_and_engine():
    _, ts = _specs("CMLS16", width=512, depth=2)
    key = np.asarray([0, 0], np.uint32)
    for bad, exc in (([-1], ValueError), ([0.5], TypeError),
                     ([1 << 33], ValueError)):
        with pytest.raises(exc):
            tadm.observe_and_admit(tsk.init(ts, device="cpu"),
                                   np.asarray(bad), key, TASPEC)
    with pytest.raises(ValueError):
        tadm.observe_and_admit(tsk.init(ts, device="cpu"), [1], key, TASPEC,
                               engine="banana")
    # the kernels run on CUDA only: a CPU table asks for the plain engine
    with pytest.raises(ValueError, match="CUDA"):
        tadm.observe_and_admit(tsk.init(ts, device="cpu"), [1], key, TASPEC,
                               engine="kernel")
    # a uint32 tensor passes as it is
    ids = torch.tensor([1, 2], dtype=torch.int32).view(torch.uint32)
    _, rows, mask = tadm.observe_and_admit(tsk.init(ts, device="cpu"), ids,
                                           key, TASPEC)
    assert rows.shape == (2,) and mask.shape == (2,)


# --------------------------------------------------------------------------
# the service's tracker-fed admission plane
# --------------------------------------------------------------------------

def test_service_admission_requires_tracker_and_policy():
    _, ts = _specs("CMS32")
    svc = TService(ts, queue_capacity=256, device="cpu")  # no track_top
    with pytest.raises(ValueError):
        svc.add_tenant("emb", admission=TASPEC)
    svc2 = TService(ts, queue_capacity=256, track_top=4, device="cpu")
    svc2.add_tenant("emb", admission=TASPEC)
    svc2.add_tenant("plain")
    with pytest.raises(ValueError):
        svc2.admit("plain", [1, 2])  # no policy registered
    assert svc2.admission_of("plain") is None
    assert svc2.admission_of("emb") == TASPEC
    with pytest.raises(KeyError):
        svc2.admission_of("nobody")
    with pytest.raises(ValueError):
        svc2.admit("emb", [1], gamma=0.9)  # plain tenant: no window args
    with pytest.raises(ValueError):
        svc2.admit("emb", [-3])
    with pytest.raises(TypeError):
        svc2.admit("emb", [1.5])


def _pair(name="CMS32", track_top=8, cap=4096):
    js, ts = _specs(name)
    a = JService(js, queue_capacity=cap, track_top=track_top)
    b = TService(ts, queue_capacity=cap, track_top=track_top, device="cpu")
    return a, b


@pytest.mark.parametrize("name", ["CMS32", "CMLS16"])
def test_service_admit_promotes_per_epoch_like_jax(name):
    a, b = _pair(name)
    a.add_tenant("emb", admission=JASPEC)
    b.add_tenant("emb", admission=TASPEC)
    ids = np.asarray([7, 3, 11, 0xFFFF_FFFF], np.uint32)
    for batch in (np.full(3, 7, np.uint32),          # below the threshold
                  np.full(50, 7, np.uint32),         # next epoch: hot
                  np.concatenate([_zipf(300, 20, seed=1),
                                  np.full(9, 0xFFFF_FFFF, np.uint32)])):
        a.enqueue("emb", batch)
        b.enqueue("emb", batch)
        want = a.admit("emb", ids)
        got = b.admit("emb", ids)
        _equal(want, got)
    assert bool(got[1][0]) and int(got[0][0]) >= TASPEC.n_fallback
    # the admitted rows follow the policy's row map from the tracker row
    tk = b.planes[0].tracker
    _equal((got[0], got[1]), tadm.admit_tracked(tk.keys[0], tk.estimates[0],
                                                tk.filled[0], ids, TASPEC))
    # a uint32 tensor is decided as it is
    _equal(got, b.admit("emb", tc.from_numpy(ids, "cpu")))


def test_service_admit_windowed_like_jax():
    """Time-scoped admission in both packages: an id whose traffic
    expired out of the ring loses its private row; n_buckets and gamma
    scope the decision; each decision persists the re-scored heap."""
    js, ts = _specs("CMS32")
    a = JService(queue_capacity=8192, track_top=8)
    b = TService(queue_capacity=8192, track_top=8, device="cpu")
    a.add_tenant("w", window=JWindowSpec(sketch=js, buckets=3, interval=60.0),
                 admission=JASPEC)
    b.add_tenant("w", window=TWindowSpec(sketch=ts, buckets=3, interval=60.0),
                 admission=TASPEC)
    a.add_tenant("p", spec=js)
    b.add_tenant("p", spec=ts)

    def both(fn):
        want, got = fn(a), fn(b)
        _equal(want, got)
        np.testing.assert_array_equal(
            np.asarray(a.planes[-1].tracker.estimates),
            b.planes[-1].tracker.estimates.numpy())
        return got

    probe = np.asarray([5, 6, 9], np.uint32)
    for keys, ts_ in ((np.full(40, 5, np.uint32), 10.0),
                      (np.full(6, 5, np.uint32), 70.0),
                      (np.full(40, 6, np.uint32), 130.0)):
        a.enqueue("w", keys, ts=ts_)
        b.enqueue("w", keys, ts=ts_)
        both(lambda s: s.admit("w", probe))
    got = both(lambda s: s.admit("w", probe, n_buckets=1))
    assert not bool(got[1][0]) and bool(got[1][1])
    got = both(lambda s: s.admit("w", probe, gamma=0.1))
    assert not bool(got[1][0])
    both(lambda s: s.admit("w", probe, mode="max"))
    for s in (a, b):
        s.enqueue("w", np.full(1, 9, np.uint32), ts=400.0)  # all expired
    got = both(lambda s: s.admit("w", probe))
    assert not bool(got[1][:2].any())
    with pytest.raises(ValueError):
        b.admit("w", probe, n_buckets=4)
