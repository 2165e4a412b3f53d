"""The port's checkpoints against the JAX package's (CPU).

Both packages drive the same seeded stream through the same service: a
plain plane with a tracker-fed admission tenant, the CMS32 metrics plane,
and a windowed plane (3 buckets of 60 s) with an admission tenant, with
events still pending in the rings when the snapshot is taken.  Then:

  * both packages' checkpoint directories hold the same leaf names,
    shapes and dtypes, and the same bytes;
  * a JAX snapshot restores into the port, and a port snapshot into
    JAX, each answering as the service that wrote it: `query_all`,
    `topk`, `admit`, and after the same further traffic the next
    flush's tables (the PRNG lanes carried over);
  * manifests downgraded to v7 ... v2 (as the reference's own tests
    build them) and a v1 single-plane checkpoint restore alike in both;
  * `packed=` both ways, `track_top` shrink and grow (`resize_stacked`,
    ties included), atomic publish, `keep_last`, a missing leaf, a shape
    mismatch, and a tiered manifest (not ported: NotImplementedError).

Tolerance: none.  Every leaf, tracker estimate and answer equals the
reference's bit for bit in every format (the reference's float32 graphs,
`core/xla_f32.py`).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core import counters as jc
from repro.core import sketch as jsk
from repro.core import topk as jtopk
from repro.stream import CountService as JService
from repro.stream import WindowSpec as JWindowSpec
from repro.stream.tiering import TierSpec
from repro.train import checkpoint as jck
from repro_torch import convert
from repro_torch.core import admission as tadm
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.core import staging as tstaging
from repro_torch.core import topk as ttopk
from repro_torch.stream import CountService as TService
from repro_torch.stream import WindowSpec as TWindowSpec
from repro_torch.train import checkpoint as tck

CAP = 1024
PLAIN = ["a", "b", "emb"]
WIN = ["w0", "w1"]
PROBES = np.arange(48, dtype=np.uint32)
IDS = np.concatenate([np.arange(24), [1000, 2000, 0xFFFF_FFFF]]).astype(
    np.uint32)


def _specs(name, packed=False, width=1024):
    return (jsk.SketchSpec(width=width, depth=2, counter=getattr(jc, name),
                           packed=packed),
            tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                           packed=packed))


def _pair(name="CMS32", packed=False, track_top=8):
    js, ts = _specs(name, packed)
    jm, tm = _specs("CMS32", width=256)
    out = []
    for svc_cls, spec, metrics, wcls, adm, kw in (
            (JService, js, jm, JWindowSpec, jadm, {}),
            (TService, ts, tm, TWindowSpec, tadm, {"device": "cpu"})):
        aspec = (None if track_top is None else
                 adm.AdmissionSpec(threshold=6.0, n_fallback=64,
                                   table_rows=4096))
        svc = svc_cls(spec, queue_capacity=CAP, seed=7, track_top=track_top,
                      **kw)
        for n in PLAIN:
            svc.add_tenant(n, admission=aspec if n == "emb" else None)
        svc.add_tenant("m", spec=metrics)
        wspec = wcls(sketch=spec, buckets=3, interval=60.0)
        for n in WIN:
            svc.add_tenant(n, window=wspec,
                           admission=aspec if n == "w0" else None)
        out.append(svc)
    return out


def _drive(services, seed, epochs=2, ts=0.0):
    """`epochs` x (an enqueue_many of every plain tenant, then one of the
    windowed tenants at event time ts += exponential(50 s))."""
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        ev = {n: (rng.zipf(1.3, 300) % 150 + i * 1000).astype(np.uint32)
              for i, n in enumerate(PLAIN)}
        ev["emb"][:40] = 3  # a hot id: admitted
        ev["m"] = (rng.zipf(1.3, 100) % 40).astype(np.uint32)
        ts += float(rng.exponential(50.0))
        wev = {n: (rng.zipf(1.3, 200) % 100 + i * 1000).astype(np.uint32)
               for i, n in enumerate(WIN)}
        for s in services:
            s.enqueue_many(ev)
            s.enqueue_many(wev, ts=ts)
    return ts


def _numpy_tree(svc):
    if isinstance(svc, TService):
        return convert.service_to_numpy(svc)[1]
    return jax.tree_util.tree_map(np.asarray, svc._tree())


def _bits(a):
    """float32 arrays as their bits (so -0.0 and NaNs compare exactly)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_leaves(x: dict, y: dict) -> None:
    """Flat {path: array} trees equal: names, order, shapes, dtypes and
    bytes."""
    assert list(x) == list(y)
    for k in x:
        a, b = np.asarray(x[k]), np.asarray(y[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


def _assert_same_state(a, b) -> None:
    _assert_leaves(tck.flatten(_numpy_tree(a)), tck.flatten(_numpy_tree(b)))
    ma, mb = a._meta(), b._meta()
    for key in ("tenant_order", "track_top", "admission", "planes",
                "windows", "stats", "seed", "queue_capacity"):
        assert ma[key] == mb[key], key


def _answer(svc):
    """Every read the slice serves, on clean planes after a flush."""
    out = {"query_all": {n: np.asarray(v)
                         for n, v in svc.query_all(PROBES).items()}}
    if svc.track_top is not None:
        for n in PLAIN + ["m"] + WIN:
            out[f"topk/{n}"] = svc.topk(n)
        out["topk/w0/n2"] = svc.topk("w0", n_buckets=2)
        for n in ("emb", "w0"):
            if svc.admission_of(n) is not None:
                rows, mask = svc.admit(n, IDS)
                out[f"admit/{n}"] = (np.asarray(rows), np.asarray(mask))
        if svc.admission_of("w0") is not None:
            rows, mask = svc.admit("w0", IDS, gamma=0.5)
            out["admit/w0/gamma"] = (np.asarray(rows), np.asarray(mask))
    return out


def _assert_answers(x: dict, y: dict) -> None:
    assert list(x) == list(y)
    for n in x["query_all"]:
        a, b = x["query_all"][n], y["query_all"][n]
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=n)
    for k in x:
        if k == "query_all":
            continue
        (ka, va), (kb, vb) = x[k], y[k]
        np.testing.assert_array_equal(ka, kb, err_msg=k)
        np.testing.assert_array_equal(_bits(va), _bits(vb), err_msg=k)


def _files(root):
    d = os.path.join(root, f"step_{tck.latest_step(root):08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_00000.npz")) as z:
        leaves = {k: z[k] for k in z.files}
    return manifest, leaves


# --------------------------------------------------------------------------
# the files
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,packed", [("CMS32", False), ("CMLS16", False),
                                         ("CMLS16", True), ("CMLS8", False)])
def test_snapshot_files_match_jax(tmp_path, name, packed):
    a, b = _pair(name, packed)
    _drive([a, b], seed=1)
    a.flush()
    b.flush()
    _drive([a, b], seed=2, ts=300.0)  # pending events ride along
    assert b.dirty_planes
    a.snapshot(str(tmp_path / "jax"), step=3)
    b.snapshot(str(tmp_path / "port"), step=3)
    ma, la = _files(str(tmp_path / "jax"))
    mb, lb = _files(str(tmp_path / "port"))
    assert ma["leaves"] == mb["leaves"]
    assert list(ma["leaves"]) == list(la) == list(lb)
    assert "windows/0/topk/keys" in la and "planes/1/fill" in la
    assert la["planes/0/fill"].dtype == np.int32
    _assert_leaves(la, lb)
    assert (ma["step"], ma["hosts"]) == (mb["step"], mb["hosts"])
    for key in ma["metadata"]:
        if key != "metrics":
            assert ma["metadata"][key] == mb["metadata"][key], key
    if name == "CMS32":  # the metrics too: the manifests are the same text
        with open(tmp_path / "jax" / "step_00000003" / "manifest.json") as f:
            text = f.read()
        with open(tmp_path / "port" / "step_00000003" / "manifest.json") as f:
            assert f.read() == text


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CMS32", "CMLS16"])
def test_jax_snapshot_restores_into_the_port(tmp_path, name):
    a, b = _pair(name)
    ts = _drive([a, b], seed=3)
    a.snapshot(str(tmp_path), step=1)
    c = TService.restore(str(tmp_path), device="cpu")
    assert c.tenants == a.tenants and c.track_top == a.track_top
    assert c.admission_of("emb") == tadm.AdmissionSpec(6.0, 64, 4096)
    assert c.stats == a.stats
    assert c.planes[0].pending() == b.planes[0].pending() > 0
    _assert_same_state(a, c)
    _assert_answers(_answer(a), _answer(c))
    _drive([a, c], seed=4, ts=ts)
    a.flush()
    c.flush()
    _assert_same_state(a, c)  # the next flush lands the same tables


@pytest.mark.parametrize("name", ["CMS32", "CMLS16"])
def test_port_snapshot_restores_into_jax(tmp_path, name):
    a, b = _pair(name)
    ts = _drive([a, b], seed=5)
    b.snapshot(str(tmp_path), step=2)
    c = JService.restore(str(tmp_path))
    assert c.admission_of("w0") == jadm.AdmissionSpec(6.0, 64, 4096)
    _assert_same_state(c, b)
    _assert_answers(_answer(c), _answer(b))
    _drive([c, b], seed=6, ts=ts)
    c.flush()
    b.flush()
    _assert_same_state(c, b)


def test_port_round_trip_restores_every_leaf(tmp_path):
    _, b = _pair("CMLS8", packed=True)
    ts = _drive([b], seed=7)
    b.snapshot(str(tmp_path), step=4)
    c = TService.restore(str(tmp_path), device="cpu")
    _assert_leaves(tck.flatten(_numpy_tree(b)), tck.flatten(_numpy_tree(c)))
    # the host staging's counters count this process's uploads, not the
    # sketch's state: the snapshot leaves them out (its manifest is the
    # reference's) and the restored service starts them anew
    want = b.metrics.snapshot()
    moved = {n: want["counters"].pop(n) for n in tstaging.COUNTERS
             if n in want["counters"]}
    assert moved["upload_bytes"] > 0 and moved["uploads"] > 0
    assert c.metrics.snapshot() == want
    assert [p.rng.draws for p in c.planes] == [p.rng.draws for p in b.planes]
    assert [p.epochs for p in c.planes[2:]] == [p.epochs for p in b.planes[2:]]
    _drive([b, c], seed=8, ts=ts)
    b.flush()
    c.flush()
    _assert_leaves(tck.flatten(_numpy_tree(b)), tck.flatten(_numpy_tree(c)))
    _assert_answers(_answer(b), _answer(c))


# --------------------------------------------------------------------------
# older manifests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("version", [7, 6, 5, 4, 3, 2])
def test_downgraded_manifest_restores_like_jax(tmp_path, version):
    """A port snapshot with its manifest stepped down as the reference's
    tests step it down (each version strips what it had not introduced
    yet: v6 the packed flag, v5 the metrics, v4 the admission map, v3
    the tracker leaves) restores alike in both packages."""
    root = str(tmp_path)
    _, b = _pair("CMS32")
    _drive([b], seed=9)
    if version == 2:
        meta = dict(b._meta(), version=2)
        del meta["track_top"]
        tck.save(root, 5, b._tree(with_topk=False), metadata=meta)
    else:
        b.snapshot(root, step=5)
    mpath = os.path.join(root, "step_00000005", "manifest.json")
    with open(mpath) as f:
        doc = json.load(f)
    meta = doc["metadata"]
    meta["version"] = version
    if version < 6:
        for pm in meta["planes"]:
            pm["spec"].pop("packed")
        for wm in meta["windows"]:
            wm["sketch"].pop("packed")
        meta["spec"].pop("packed")
    if version < 5:
        meta.pop("metrics")
    if version < 4:
        meta.pop("admission")
    with open(mpath, "w") as f:
        json.dump(doc, f)
    kw = {"track_top": 6} if version == 2 else {}
    a = JService.restore(root, **kw)
    c = TService.restore(root, device="cpu", **kw)
    assert c.track_top == a.track_top == (6 if version == 2 else 8)
    if version == 2:
        assert not bool(c.planes[0].tracker.filled.any())  # cold heaps
    assert c.metrics.snapshot() == a.metrics.snapshot()
    assert c.stats == a.stats == b.stats
    _assert_same_state(a, c)
    _assert_answers(_answer(a), _answer(c))
    assert (c.admission_of("emb") is None) == (version < 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_v1_checkpoint_replays_its_host_queue(tmp_path, writer):
    """The pre-plane layout (v1: one spec, a host queue, no version key):
    tables load directly and the saved queue replays into the ring."""
    js, ts = _specs("CMS32")
    tables = np.stack([np.asarray(jsk.update_batched(
        jsk.init(js), jnp.asarray(np.arange(50 * t, 50 * t + 500) % 97,
                                  jnp.uint32),
        jax.random.PRNGKey(t)).table) for t in range(2)])
    queue = np.zeros((2, 256), np.uint32)
    queue[1, :40] = 777
    queue[0, :3] = [1, 2, 3]
    fill = np.array([3, 40], np.int64)
    c = js.counter
    meta = {"tenants": ["x", "y"], "queue_capacity": 256,
            "stats": {"events": 43, "flushes": 0},
            "spec": {"width": js.width, "depth": js.depth, "seed": js.seed,
                     "counter": {"kind": c.kind, "base": c.base,
                                 "bits": c.bits}}}
    rng_leaf = np.asarray([0, 5], np.uint32)
    if writer == "jax":
        jck.save(str(tmp_path), 11, {"tables": jnp.asarray(tables),
                                     "queue": jnp.asarray(queue),
                                     "fill": jnp.asarray(fill),
                                     "rng": jnp.asarray(rng_leaf)},
                 metadata=meta)
    else:
        tck.save(str(tmp_path), 11, {"tables": tables, "queue": queue,
                                     "fill": fill.astype(np.int32),
                                     "rng": rng_leaf}, metadata=meta)
    a = JService.restore(str(tmp_path))
    b = TService.restore(str(tmp_path), device="cpu", track_top=4)
    assert b.tenants == ["x", "y"] and b.track_top == 4
    assert b.planes[0].pending() == 43
    assert b.stats == a.stats == {"events": 43, "flushes": 0}
    ta, tb = _numpy_tree(a)["planes"][0], _numpy_tree(b)["planes"][0]
    for key in ("tables", "queue", "fill"):
        np.testing.assert_array_equal(ta[key], tb[key])
    qa, qb = a.query_all(PROBES), b.query_all(PROBES)  # flushes the replay
    for n in ("x", "y"):
        np.testing.assert_array_equal(np.asarray(qa[n]), qb[n].numpy())
    assert float(b.query("y", [777])[0]) >= 40
    np.testing.assert_array_equal(np.asarray(a.planes[0].tables),
                                  tc.to_numpy(b.planes[0].tables))


# --------------------------------------------------------------------------
# repack and re-arm on load
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,packed", [("CMLS16", True), ("CMLS16", False),
                                         ("CMLS8", True), ("CMLS8", False)])
def test_restore_repacks_like_jax(tmp_path, name, packed):
    """A snapshot stored one way restores the other way (`packed=`) in
    both packages, cell for cell: same leaves, and the port's answers
    bit-identical to the service that wrote it."""
    a, b = _pair(name, packed=not packed)
    _drive([a, b], seed=10)
    b.snapshot(str(tmp_path), step=1)
    want = {n: v.numpy() for n, v in b.query_all(PROBES).items()}
    ja = JService.restore(str(tmp_path), packed=packed)
    c = TService.restore(str(tmp_path), device="cpu", packed=packed)
    assert c.spec.packed == packed and c.spec_of("w0").packed == packed
    assert c.planes[0].tables.dtype == (torch.uint32 if packed
                                        else getattr(tc, name).dtype)
    _assert_same_state(ja, c)
    got = c.query_all(PROBES)
    for n in want:
        np.testing.assert_array_equal(want[n], got[n].numpy(), err_msg=n)


@pytest.mark.parametrize("k", [3, 8, 12])
def test_restore_rearms_trackers_like_jax(tmp_path, k):
    a, b = _pair("CMS32")
    _drive([a, b], seed=11, epochs=3)
    b.snapshot(str(tmp_path), step=1)
    top = {n: b.topk(n) for n in PLAIN}
    ja = JService.restore(str(tmp_path), track_top=k)
    c = TService.restore(str(tmp_path), device="cpu", track_top=k)
    assert c.track_top == k and c.planes[0].tracker.keys.shape == (3, k)
    _assert_same_state(ja, c)
    if k > 8:  # grown slots are cold until the next flush
        assert not bool(c.planes[0].tracker.filled[:, 8:].any())
    for n in PLAIN:
        keys, est = c.topk(n, min(k, 8))
        np.testing.assert_array_equal(keys, top[n][0][:k])
        np.testing.assert_array_equal(est, top[n][1][:k])
    _assert_answers(_answer(ja), _answer(c))


@pytest.mark.parametrize("k", [1, 2, 5, 7, 9])
def test_resize_stacked_matches_jax_ties_included(k):
    """Shrink keeps each row's best k by stored estimate, ties broken by
    the lower slot (jax.lax.top_k), unfilled slots last; grow appends
    cold slots."""
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 2**32, (4, 7), dtype=np.uint64).astype(np.uint32)
    est = rng.integers(0, 3, (4, 7)).astype(np.float32)  # many ties
    filled = rng.random((4, 7)) < 0.7
    est[~filled] = -np.inf
    filled[0, 2] = False  # an unfilled slot with a finite stale estimate
    est[0, 2] = 99.0
    want = jtopk.resize_stacked(
        jtopk.TopK(jnp.asarray(keys), jnp.asarray(est), jnp.asarray(filled)),
        k)
    got = ttopk.resize_stacked(
        ttopk.TopK(tc.from_numpy(keys, "cpu"), torch.from_numpy(est),
                   torch.from_numpy(filled)), k)
    np.testing.assert_array_equal(np.asarray(want.keys),
                                  tc.to_numpy(got.keys))
    np.testing.assert_array_equal(np.asarray(want.estimates),
                                  got.estimates.numpy())
    np.testing.assert_array_equal(np.asarray(want.filled), got.filled.numpy())


def test_tiered_snapshot_restores(tmp_path):
    """A tiered JAX snapshot (v8: membership in the manifest, the cold
    store and the queue mirrors among the leaves) restores into a tiered
    port service holding the same leaves, answering alike."""
    js, _ = _specs("CMS32")
    a = JService(js, tenants=("x", "y", "z"), queue_capacity=256,
                 track_top=4, tier=TierSpec(max_hot_tenants=1))
    for n in ("x", "y", "z"):
        a.enqueue(n, np.arange(20, dtype=np.uint32))
    a.snapshot(str(tmp_path), step=1)
    b = TService.restore(str(tmp_path), device="cpu")
    assert b.tier_occupancy() == {"p0": {"hot": 1, "cold": 2}}
    _, tree = convert.service_to_numpy(b)
    want = jax.tree_util.tree_map(np.asarray, a._tree())
    for key in ("tables", "cold_tables", "queue", "fill"):
        got_leaf, want_leaf = tree["planes"][0][key], want["planes"][0][key]
        assert got_leaf.dtype == want_leaf.dtype
        np.testing.assert_array_equal(got_leaf, want_leaf)
    probes = np.arange(24, dtype=np.uint32)
    qa, qb = a.query_all(probes), b.query_all(probes)
    for n in ("x", "y", "z"):
        np.testing.assert_array_equal(np.asarray(qa[n]), qb[n].numpy())
        np.testing.assert_array_equal(np.asarray(a.topk(n)[0]), b.topk(n)[0])


# --------------------------------------------------------------------------
# train/checkpoint
# --------------------------------------------------------------------------

def test_checkpoint_round_trip_gc_and_cross_package(tmp_path):
    root = str(tmp_path / "ck")
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "n": {"b": tc.from_numpy(np.asarray([1, 0xFFFF_FFFF], np.uint32),
                                     "cpu"),
                  "c": [np.asarray([True, False]),
                        np.asarray([7], np.int32)]}}
    for step in (1, 2, 3, 4, 5):
        tck.save(root, step, tree, keep_last=2)
    assert tck.latest_step(root) == 5
    assert sorted(os.listdir(root)) == ["step_00000004", "step_00000005"]
    assert list(_files(root)[1]) == ["n/b", "n/c/0", "n/c/1", "w"]
    like = {"w": tck.Leaf((2, 3), torch.float32),
            "n": {"b": torch.zeros(2, dtype=torch.int32).view(torch.uint32),
                  "c": [tck.Leaf((2,), np.bool_), np.zeros(1, np.int32)]}}
    got, manifest = tck.restore(root, like, device="cpu")
    assert manifest["step"] == 5
    assert torch.equal(got["w"], tree["w"])
    assert got["n"]["b"].dtype == torch.uint32
    np.testing.assert_array_equal(tc.to_numpy(got["n"]["b"]),
                                  [1, 0xFFFF_FFFF])
    assert isinstance(got["n"]["c"][0], np.ndarray)
    np.testing.assert_array_equal(got["n"]["c"][0], [True, False])
    # the reference reads the port's files, and the port the reference's
    jlike = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
        tck.to_host(tree))
    jgot, _ = jck.restore(root, jlike)
    np.testing.assert_array_equal(np.asarray(jgot["n"]["b"]),
                                  [1, 0xFFFF_FFFF])
    jck.save(str(tmp_path / "j"), 9, jax.tree_util.tree_map(jnp.asarray,
                                                            tck.to_host(tree)))
    back, _ = tck.restore(str(tmp_path / "j"), like, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    assert tck.load_metadata(str(tmp_path / "j"))[1] == 9


def test_checkpoint_atomic_async_and_errors(tmp_path):
    root = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        tck.load_metadata(root)
    tck.save(root, 7, {"x": torch.zeros(3)}, metadata={"k": 1})
    assert not any(d.endswith(".tmp") for d in os.listdir(root))
    # a step left half written (.tmp) is never the latest
    os.makedirs(os.path.join(root, "step_00000009.tmp"))
    assert tck.latest_step(root) == 7
    assert tck.load_metadata(root) == ({"k": 1}, 7)
    t = tck.save_async(root, 8, {"x": torch.ones(3)})
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = tck.restore(root, {"x": torch.zeros(3)})
    assert torch.equal(got["x"], torch.ones(3))
    with pytest.raises(KeyError, match="missing leaf y"):
        tck.restore(root, {"x": torch.zeros(3), "y": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaf x"):
        tck.restore(root, {"x": torch.zeros(4)})
