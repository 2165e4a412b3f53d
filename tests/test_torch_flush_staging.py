"""The flush's staging and row maps (CPU), against the JAX package.

A flush uploads its small host arrays (active rows, fills, the uniform
draw's row offsets, window weights, the rotation's cleared buckets)
through `core.staging`: reused host slots, pinned on a GPU and copied
without a synchronize; on the CPU the same packing into plain slots.  The
row-mapped kernels (`fused_update_rows`, `window_query_stacked_rows`)
take their row map as host integers, passed to the kernel by value up to
MAX_MAPPED_ROWS rows a launch.  On the CPU the wrappers run the plain
versions, so these tests hold the staging, the row-map checks and the
window flush against the JAX package's results; the kernels themselves
are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import hashing as jh
from repro.core import sketch as jsk
from repro.kernels import ref as jref
from repro.stream import CountService as JService
from repro.stream import WindowSpec as JWindowSpec
from repro_torch import convert
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.core import staging
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sketch as tks
from repro_torch.stream import CountService as TService
from repro_torch.stream import WindowSpec as TWindowSpec

CSRC = pathlib.Path(tks.__file__).parent / "csrc"


def test_row_map_cap_matches_the_cuda_source():
    """MAX_MAPPED_ROWS mirrors CML_ROWMAP_MAX_ROWS, the rows one launch of
    a row-mapped kernel carries by value; small calls pass CML_SMALL_ROWS
    and the cap holds more."""
    src = (CSRC / "common.cuh").read_text()
    cap = re.search(r"#define CML_ROWMAP_MAX_ROWS (\d+)", src)
    small = re.search(r"#define CML_SMALL_ROWS (\d+)", src)
    assert cap and int(cap.group(1)) == tks.MAX_MAPPED_ROWS
    assert small and int(small.group(1)) < tks.MAX_MAPPED_ROWS


@pytest.mark.parametrize("rows", [[3, 0, 7], np.array([[5], [1]]),
                                  (2,), np.arange(4, dtype=np.int32)])
def test_host_rows_are_contiguous_int64(rows):
    got = tks._host_rows(rows, 8, unique=True)
    assert got.dtype == np.int64 and got.flags["C_CONTIGUOUS"]
    assert got.tolist() == np.asarray(rows).reshape(-1).tolist()


@pytest.mark.parametrize("rows,unique,message", [
    ([0, 8], True, "rows outside"),
    ([-1, 2], True, "rows outside"),
    ([2, 5, 2], True, "rows must be unique"),
    ([2, 2], False, None),                 # a read may repeat rings
    ([9], False, "rows outside"),
])
def test_host_rows_checks(rows, unique, message):
    if message is None:
        assert tks._host_rows(rows, 8, unique).tolist() == rows
        return
    with pytest.raises(ValueError, match=message):
        tks._host_rows(rows, 8, unique)


def _cms_spec(width=256):
    return (jsk.SketchSpec(width=width, depth=2, counter=jc.CMS32),
            tsk.SketchSpec(width=width, depth=2, counter=tc.CMS32))


def test_update_rows_past_the_row_cap_equal_jax():
    """A row-mapped update of MAX_MAPPED_ROWS + 37 rows (two launches on a
    GPU) lands what the JAX package's XLA engine lands, cell for cell,
    and leaves the unlisted tables alone; repeated rows raise."""
    jspec, tspec = _cms_spec(128)
    t = tks.MAX_MAPPED_ROWS + 40
    rng = np.random.default_rng(0)
    base = rng.integers(0, 50, (t, 2, 128)).astype(np.uint32)
    rows = rng.permutation(t)[:t - 3]
    raw = (rng.zipf(1.3, (rows.size, 300)) % 400).astype(np.uint32)
    weights = np.ones(raw.shape, np.float32)
    weights[:, -40:] = 0.0
    unif = rng.random(raw.shape, dtype=np.float32)
    skeys, mult = tsk.dedup_weighted(torch.from_numpy(raw.astype(np.int64)),
                                     torch.from_numpy(weights))
    tables = tc.from_numpy(base.copy(), "cpu")
    tks.fused_update_rows(tables, tc.from_i64(skeys, torch.uint32), mult,
                          torch.from_numpy(unif), rows,
                          seeds=tops._seeds_tuple(tspec), width=128,
                          counter=tspec.counter)
    jseeds = jnp.asarray(jh.host_row_seeds(jspec.seed, 2), jnp.uint32)
    want, _ = jref.update_score_rows_ref(
        jnp.asarray(base), jnp.asarray(skeys.numpy().astype(np.uint32)),
        jnp.asarray(mult.numpy()), jnp.asarray(unif),
        jnp.asarray(rows.astype(np.int32)),
        jnp.zeros((rows.size, 1), jnp.uint32), jseeds, jspec.counter,
        tks.CHUNK)
    got = tc.to_numpy(tables)
    np.testing.assert_array_equal(got, np.asarray(want))
    untouched = np.setdiff1d(np.arange(t), rows)
    np.testing.assert_array_equal(got[untouched], base[untouched])
    with pytest.raises(ValueError, match="unique"):
        tks.fused_update_rows(tables, tc.from_i64(skeys, torch.uint32)[:2],
                              mult[:2], torch.from_numpy(unif[:2]),
                              [rows[0], rows[0]],
                              seeds=tops._seeds_tuple(tspec), width=128,
                              counter=tspec.counter)


def test_window_query_rows_past_the_row_cap_equal_jax():
    """MAX_MAPPED_ROWS + 37 rings (repeats allowed) of a (T, B, d, w)
    leaf, read in place: equal to the JAX package's XLA engine."""
    jspec, tspec = _cms_spec(128)
    rng = np.random.default_rng(1)
    leaf = rng.integers(0, 90, (6, 4, 2, 128)).astype(np.uint32)
    rows = rng.integers(0, 6, tks.MAX_MAPPED_ROWS + 37)
    keys = rng.integers(0, 500, (rows.size, 40)).astype(np.uint32)
    weights = rng.random((rows.size, 4), dtype=np.float32)
    got = tks.window_query_stacked_rows(
        tc.from_numpy(leaf, "cpu"), tc.from_numpy(keys, "cpu"),
        torch.from_numpy(weights), rows, seeds=tops._seeds_tuple(tspec),
        width=128, counter=tspec.counter)
    jseeds = jnp.asarray(jh.host_row_seeds(jspec.seed, 2), jnp.uint32)
    want = jref.window_query_stacked_rows_ref(
        jnp.asarray(leaf), jnp.asarray(keys), jnp.asarray(weights),
        jnp.asarray(rows.astype(np.int32)), jseeds, jspec.counter)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_staging_reuses_its_slots_and_keeps_each_upload():
    """On the CPU the staging packs into plain host slots used in turn:
    after a full ring of uploads the first slot is packed again (same
    storage), and every tensor handed out keeps its own values."""
    st = staging.HostStaging("cpu", slots=3)
    first = [st.upload(np.arange(k, k + 5, dtype=np.int64),
                       np.full(3, k, np.float32)) for k in range(3)]
    ptrs = [h.data_ptr() for h in st.host]
    assert not any(h.is_pinned() for h in st.host)
    again = st.upload(np.arange(40, 45, dtype=np.int64),
                      np.full(3, 9, np.float32))
    assert st.host[0].data_ptr() == ptrs[0]  # slot 0 packed again
    for k, (rows, vals) in enumerate(first):
        assert rows.dtype == torch.int64 and vals.dtype == torch.float32
        assert rows.tolist() == list(range(k, k + 5))
        assert vals.tolist() == [float(k)] * 3
    assert again[0].tolist() == list(range(40, 45))
    # a wider upload grows its slot; the arrays keep dtype and shape
    wide = st.upload(np.arange(12, dtype=np.int32).reshape(3, 4))[0]
    assert wide.shape == (3, 4) and wide.dtype == torch.int32
    assert st.host[1].numel() >= 48


def test_shared_staging_is_one_per_device():
    a = staging.upload("cpu", np.array([1, 2], np.int64))[0]
    b = staging.upload(torch.device("cpu"), np.array([3], np.int64))[0]
    assert a.tolist() == [1, 2] and b.tolist() == [3]
    assert len([d for d in staging._SHARED if d.type == "cpu"]) == 1


def test_flush_inputs_and_rotation_go_through_staging(monkeypatch):
    """The flush's uploads (rows and fills, the uniform offsets, window
    weights, the rotation's buckets) all pass through `staging.upload`."""
    seen = []
    real = staging.upload

    def spy(device, *arrays):
        seen.append(tuple(a.shape for a in arrays))
        return real(device, *arrays)
    monkeypatch.setattr(staging, "upload", spy)
    queue = tops.queue_init(3, 256, "cpu")
    keys, live = tops.flush_rows_inputs(queue, [5, 9], [2, 0], 128)
    assert keys.shape == (2, 128) and live[0, :5].sum() == 5
    assert seen[-1] == ((2,), (2,))  # rows and fills, one upload
    leaf = tc.zeros((3, 4, 2, 128), torch.uint32, "cpu")
    tops.window_advance_rows(leaf, [0, 1, 2], [1, 0, 5])
    assert seen[-1] == ((5,),)  # ring 0 one bucket, ring 2 all four
    from repro_torch.core import prng
    prng.uniform_rows([1, 2], 4, 16, [3, 1])
    assert seen[-1] == ((2,),)


def _window_pair(track_top=8):
    jspec, tspec = _cms_spec(512)
    jw = JWindowSpec(sketch=jspec, buckets=4, interval=60.0)
    tw = TWindowSpec(sketch=tspec, buckets=4, interval=60.0)
    a = JService(queue_capacity=4096, seed=3, track_top=track_top)
    b = TService(queue_capacity=4096, seed=3, track_top=track_top,
                 device="cpu")
    for name in ("x", "y", "z"):
        a.add_tenant(name, window=jw)
        b.add_tenant(name, window=tw)
    return a, b


def _assert_same(a, b):
    ta = jax.tree_util.tree_map(np.asarray, a._tree())
    _, tb = convert.service_to_numpy(b)
    for la, lb in zip(ta["windows"], tb["windows"]):
        for key in ("tables", "cursor", "epoch", "queue", "fill"):
            np.testing.assert_array_equal(la[key], lb[key])
        for key in ("keys", "estimates", "filled"):
            np.testing.assert_array_equal(la["topk"][key],
                                          lb["topk"][key])


@pytest.mark.parametrize("classes", [1, 2])
def test_window_flush_with_repeated_candidates_equals_jax(classes):
    """A window flush of one and of two fill classes, on duplicate-heavy
    Zipf batches (the tracker refresh scores every candidate slot, most
    of them repeats of a few keys), equal to the JAX package's
    WindowPlane: leaves, cursors, watermarks, rings, fills and trackers,
    converted through `convert.py`."""
    a, b = _window_pair()
    rng = np.random.default_rng(7 + classes)
    for svc in (a, b):
        svc.enqueue_many({n: np.arange(3, dtype=np.uint32)
                          for n in ("x", "y", "z")}, ts=30.0)
    sizes = {"x": 700, "y": 700, "z": 700} if classes == 1 else \
        {"x": 300, "y": 1500, "z": 1400}
    batches = {n: (rng.zipf(1.6, k) % 40).astype(np.uint32)
               for n, k in sizes.items()}
    for svc in (a, b):
        svc.enqueue_many(batches, ts=90.0)  # rotates, flushing the first
        svc.flush()
    _assert_same(a, b)
    for name in ("x", "z"):
        (ka, ea), (kb, eb) = a.topk(name, 5), b.topk(name, 5)
        np.testing.assert_array_equal(kb, ka)
        np.testing.assert_array_equal(eb, ea)
