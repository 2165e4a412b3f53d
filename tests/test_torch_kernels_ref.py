"""The port's plain kernel versions against the JAX package's kernels.

Each plain version in `repro_torch/kernels/ref.py` (what the CUDA kernels
are held to on the card, and what the kernel wrappers run for CPU
tensors) is compared with the reference's Pallas kernel, run in
interpret mode at 1-2 tenants x 2 chunks, and with the reference's XLA
engines (`repro/kernels/ref.py`, which the JAX package's own tests hold
bit-identical to its kernels) at larger sizes.

Tolerances: the linear counter (CMS32) and the rings match exactly.  For
log counters the raw cell states read by a query match exactly; decoded
estimates are within 8 ulp (JAX's and torch's float32 expm1 differ), and
an update may land a few cells one state apart, because `nfold`'s
stochastic rounding threshold moves by an ulp (see test_torch_counters).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import hashing as jh
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sketch as jks
from repro_torch.core import counters as tc
from repro_torch.core import hashing as th
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sketch as tks

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
SEEDS = jh.host_row_seeds(0x5EED, 2)
CHUNK = tks.CHUNK


def _counters(name):
    return getattr(jc, name), getattr(tc, name)


def _tables(name, packed, t, width, seed, fill=True):
    """(T, d, sw) storage tables with random states, numpy."""
    jcnt, _ = _counters(name)
    rng = np.random.default_rng(seed)
    hi = min(jcnt.max_state, 2000) if fill else 0
    cells = rng.integers(0, hi + 1, (t, 2, width)).astype(np.uint32)
    if packed:
        return np.asarray(jc.pack_table(jnp.asarray(cells), jcnt.bits))
    return cells.astype(jcnt.dtype)


def _t(a):
    return tc.from_numpy(np.asarray(a), "cpu")


def _check_states(name, got, want, max_frac=0.0):
    """Storage tables equal (CMS32) or, for log cells, differing in at
    most `max_frac` of cells and only by one state."""
    jcnt, _ = _counters(name)
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if jcnt.kind == "linear" or max_frac == 0.0:
        assert np.array_equal(got, want)
        return
    bits = jcnt.bits
    if got.dtype == np.uint32 and bits < 32:
        got = np.asarray(jc.unpack_table(jnp.asarray(got), bits))
        want = np.asarray(jc.unpack_table(jnp.asarray(want), bits))
    diff = got.astype(np.int64) - want.astype(np.int64)
    assert (diff != 0).mean() <= max_frac, f"{int((diff != 0).sum())} cells"
    assert np.abs(diff).max() <= 1


def _check_est(name, got, want):
    jcnt, _ = _counters(name)
    if jcnt.kind == "linear":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, np.asarray(want), maxulp=8)


# --------------------------------------------------------------------------
# query
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,packed", FORMATS)
def test_fused_query_plain_vs_pallas(name, packed):
    jcnt, tcnt = _counters(name)
    width = 512
    cpl = jcnt.cells_per_lane if packed else 1
    tables = _tables(name, packed, 2, width, 1)
    keys = np.random.default_rng(2).integers(0, 2**32, (2, 2 * CHUNK),
                                             dtype=np.uint64).astype(np.uint32)
    keys[0, :2] = [0, 0xFFFF_FFFF]
    want = np.asarray(jks.fused_query_pallas(
        jnp.asarray(tables), jnp.asarray(keys), seeds=SEEDS, width=width,
        counter=jcnt, interpret=True, cpl=cpl))
    got = tks.fused_query(_t(tables), _t(keys), seeds=SEEDS, width=width,
                          counter=tcnt, cpl=cpl).numpy()
    _check_est(name, got, want)
    # the cell states under the decode match exactly
    jspec = jsk.SketchSpec(width=width, counter=jcnt, packed=packed)
    tspec = tsk.SketchSpec(width=width, counter=tcnt, packed=packed)
    for t in range(2):
        js = np.asarray(jsk.query_state(jsk.Sketch(jnp.asarray(tables[t]),
                                                   jspec), jnp.asarray(keys[t])))
        ts = tsk.query_state(tsk.Sketch(_t(tables[t]), tspec), _t(keys[t]))
        assert np.array_equal(ts.numpy(), js.astype(np.int64))


@pytest.mark.parametrize("name,packed", [("CMS32", False), ("CMLS16", True)])
def test_query_ref_and_ops_vs_xla(name, packed):
    jcnt, tcnt = _counters(name)
    width = 1024
    cpl = jcnt.cells_per_lane if packed else 1
    tables = _tables(name, packed, 5, width, 3)
    keys = np.random.default_rng(4).integers(0, 5000, (5, 300)).astype(
        np.uint32)
    seeds = jh.make_row_seeds(0x5EED, 2)
    for t in range(5):
        want = np.asarray(jref.query_ref(jnp.asarray(tables[t]),
                                         jnp.asarray(keys[t]), seeds, jcnt,
                                         cpl=cpl))
        got = tref.query_ref(_t(tables[t]), _t(keys[t]),
                             th.make_row_seeds(0x5EED, 2), tcnt, cpl=cpl)
        _check_est(name, got.numpy(), want)
    tspec = tsk.SketchSpec(width=width, counter=tcnt, packed=packed)
    many = tops.query_many(_t(tables), tspec, keys[0]).numpy()
    stacked = tsk.query_stacked(_t(tables), tspec,
                                _t(np.broadcast_to(keys[0], (5, 300))))
    assert np.array_equal(many, stacked.numpy())


# --------------------------------------------------------------------------
# fused update + score
# --------------------------------------------------------------------------

def _update_inputs(t_rows, n, seed, universe=400):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, universe, (t_rows, n)).astype(np.uint32)
    raw[0, :3] = [0, 0xFFFF_FFFF, 0xFFFF_FFFF]
    weights = (rng.random((t_rows, n)) < 0.9).astype(np.float32)
    sk_keys, mult = [], []
    for i in range(t_rows):
        k, m = jsk.dedup_weighted(jnp.asarray(raw[i]), jnp.asarray(weights[i]))
        sk_keys.append(np.asarray(k))
        mult.append(np.asarray(m))
    unif = rng.random((t_rows, n), dtype=np.float32)
    return raw, weights, np.stack(sk_keys), np.stack(mult), unif


@pytest.mark.parametrize("name,packed", FORMATS)
def test_fused_update_score_plain_vs_pallas(name, packed):
    """Narrow rows (128 cells) with 2 chunks of keys: cross-chunk
    collisions, mult == 0 entries, nonzero starting states, a row map
    that skips and reorders rows.  The wrapper draws its uniforms from the
    flush key over the dense (3, N) grid at the rows; the Pallas kernel
    is fed the reference's own draw of the same grid."""
    jcnt, tcnt = _counters(name)
    width = 128
    cpl = jcnt.cells_per_lane if packed else 1
    tables = _tables(name, packed, 3, width, 5)
    _, _, keys, mult, _ = _update_inputs(2, 2 * CHUNK, 6)
    rows = np.asarray([2, 0], np.int32)
    key = np.asarray([6, 9], np.uint32)
    unif = jops._parity_uniforms(key, 2 * CHUNK, 3, rows)
    cand = np.concatenate([keys[:, :40], np.asarray([[0, 0xFFFF_FFFF]] * 2,
                                                    np.uint32)], axis=1)
    jt, jest = jks.fused_update_score_pallas(
        jnp.asarray(tables), jnp.asarray(keys), jnp.asarray(mult),
        unif, jnp.asarray(cand), jnp.asarray(rows), seeds=SEEDS,
        width=width, counter=jcnt, interpret=True, cpl=cpl)
    tt = _t(tables)
    out, test = tks.fused_update_score(
        tt, _t(keys), _t(mult), key, _t(cand), rows, seeds=SEEDS,
        width=width, counter=tcnt, cpl=cpl)
    assert out is tt  # in place
    _check_states(name, tc.to_numpy(out), jt, max_frac=0.02)
    assert np.array_equal(tc.to_numpy(out)[1], tables[1])  # unlisted row
    if jcnt.kind == "linear":
        assert np.array_equal(test.numpy(), np.asarray(jest))
    else:
        # estimates of cells that landed alike agree within 8 ulp
        np.testing.assert_allclose(test.numpy(), np.asarray(jest),
                                   rtol=2 * (jcnt.base - 1) + 1e-5)


_xla_update_score = jax.jit(jref.update_score_rows_ref,
                            static_argnames=("counter", "chunk", "cpl"))


@pytest.mark.parametrize("name,packed", [("CMS32", False), ("CMLS16", True),
                                         ("CMLS8", False)])
def test_update_score_rows_ref_vs_xla_engine(name, packed):
    """Larger case through the reference's XLA engine: 5 tenants, a row
    subset of 3, 2 chunks + a ragged tail."""
    jcnt, tcnt = _counters(name)
    width = 2048
    cpl = jcnt.cells_per_lane if packed else 1
    tables = _tables(name, packed, 5, width, 7)
    _, _, keys, mult, unif = _update_inputs(3, 2 * CHUNK + 100, 8, 6000)
    rows = np.asarray([4, 1, 2], np.int32)
    cand = keys[:, ::7].copy()
    jt, jest = _xla_update_score(
        jnp.asarray(tables), jnp.asarray(keys), jnp.asarray(mult),
        jnp.asarray(unif), jnp.asarray(rows), jnp.asarray(cand),
        jh.make_row_seeds(0x5EED, 2), counter=jcnt, chunk=CHUNK, cpl=cpl)
    out, test = tref.update_score_rows_ref(
        _t(tables), _t(keys), _t(mult), _t(unif), _t(rows), _t(cand),
        th.make_row_seeds(0x5EED, 2), tcnt, CHUNK, cpl=cpl)
    _check_states(name, tc.to_numpy(out), jt, max_frac=0.01)
    if jcnt.kind == "linear":
        assert np.array_equal(test.numpy(), np.asarray(jest))


def test_update_chunked_and_one_shot_cms32_exact():
    chunk = 256
    jcnt, tcnt = _counters("CMS32")
    table = _tables("CMS32", False, 1, 128, 9)[0]
    _, _, keys, mult, unif = _update_inputs(1, 700, 10, 300)
    seeds_j, seeds_t = jh.make_row_seeds(0x5EED, 2), th.make_row_seeds(0x5EED, 2)
    want = np.asarray(jax.jit(jref.update_chunked_ref,
                              static_argnames=("counter", "chunk"))(
        jnp.asarray(table), jnp.asarray(keys[0]), jnp.asarray(mult[0]),
        jnp.asarray(unif[0]), seeds_j, counter=jcnt, chunk=chunk))
    got = tref.update_chunked_ref(_t(table), _t(keys[0]), _t(mult[0]),
                                  _t(unif[0]), seeds_t, tcnt, chunk)
    assert np.array_equal(tc.to_numpy(got), want)
    want1 = np.asarray(jref.update_ref(
        jnp.asarray(table), jnp.asarray(keys[0]), jnp.asarray(mult[0]),
        jnp.asarray(unif[0]), seeds_j, jcnt))
    got1 = tref.update_ref(_t(table), _t(keys[0]), _t(mult[0]), _t(unif[0]),
                           seeds_t, tcnt)
    assert np.array_equal(tc.to_numpy(got1), want1)


def test_update_score_rows_op_matches_reference_op():
    """The whole op: dedup + parity uniforms + update + score, CMS32."""
    jcnt, tcnt = _counters("CMS32")
    jspec = jsk.SketchSpec(width=256, counter=jcnt)
    tspec = tsk.SketchSpec(width=256, counter=tcnt)
    tables = _tables("CMS32", False, 4, 256, 11)
    raw, weights, _, _, _ = _update_inputs(2, 2 * CHUNK, 12, 500)
    rows = np.asarray([3, 1], np.int32)
    cand = raw[:, :64].copy()
    key = np.asarray([3, 7], np.uint32)
    jt, jest = jops.update_score_rows(
        jnp.asarray(tables), jspec, jnp.asarray(raw), key, rows,
        jnp.asarray(cand), weights=jnp.asarray(weights), engine="xla")
    for engine in ("auto", "plain"):
        tt, test = tops.update_score_rows(
            _t(tables), tspec, _t(raw), key, rows, _t(cand),
            weights=_t(weights), engine=engine)
        assert np.array_equal(tc.to_numpy(tt), np.asarray(jt))
        assert np.array_equal(test.numpy(), np.asarray(jest))


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_weighted_exact(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 50, (3, 500)).astype(np.uint32)
    keys[0, :4] = [0xFFFF_FFFF, 0, 0xFFFF_FFFF, 0]
    w = (rng.random((3, 500)) < 0.7).astype(np.float32)
    k_t, m_t = tsk.dedup_weighted(_t(keys), _t(w))
    for i in range(3):
        k_j, m_j = jsk.dedup_weighted(jnp.asarray(keys[i]), jnp.asarray(w[i]))
        assert np.array_equal(k_t[i].numpy(), np.asarray(k_j).astype(np.int64))
        assert np.array_equal(m_t[i].numpy(), np.asarray(m_j))


# --------------------------------------------------------------------------
# ring appends
# --------------------------------------------------------------------------

def _ring(t, capw, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, (t, capw), dtype=np.uint64).astype(np.uint32)


def test_queue_append_plain_vs_pallas_and_xla():
    queue = _ring(4, 256, 13)
    rng = np.random.default_rng(14)
    keys = rng.integers(0, 2**32, (3, 128), dtype=np.uint64).astype(np.uint32)
    rows, fill, count = (np.asarray([3, 0, 2], np.int32),
                         np.asarray([0, 100, 255], np.int32),
                         np.asarray([128, 17, 1], np.int32))
    meta = np.stack([rows, fill, count])
    want = np.asarray(jks.queue_append_pallas(
        jnp.asarray(queue), jnp.asarray(keys), jnp.asarray(meta),
        interpret=True))
    want_x = np.asarray(jops.queue_append(jnp.asarray(queue),
                                          jnp.asarray(keys), rows, fill,
                                          count, engine="xla"))
    assert np.array_equal(want, want_x)
    q = _t(queue)
    got = tks.queue_append(q, _t(keys), rows, fill, count)
    assert got is q and np.array_equal(tc.to_numpy(got), want)
    for engine in ("auto", "plain"):
        got = tops.queue_append(_t(queue), _t(keys), rows, fill, count,
                                engine=engine)
        assert np.array_equal(tc.to_numpy(got), want)


def test_queue_append_dense_plain_vs_pallas():
    queue = _ring(3, 384, 15)
    keys = np.random.default_rng(16).integers(
        0, 2**32, (3, 200), dtype=np.uint64).astype(np.uint32)
    fill, count = (np.asarray([0, 184, 5], np.int32),
                   np.asarray([200, 200, 0], np.int32))
    want = np.asarray(jks.queue_append_dense_pallas(
        jnp.asarray(queue), jnp.asarray(keys),
        jnp.asarray(np.stack([fill, count])), interpret=True))
    got = tks.queue_append_dense(_t(queue), _t(keys), fill, count)
    assert np.array_equal(tc.to_numpy(got), want)
    got = tops.queue_append(_t(queue), _t(keys), np.arange(3), fill, count,
                            engine="plain")
    assert np.array_equal(tc.to_numpy(got), want)


@pytest.mark.parametrize("rows,fill,count", [
    ([0, 0], [0, 0], [1, 1]),       # rows not unique
    ([5], [0], [1]),                # row outside the ring
    ([1], [250], [10]),             # fill + count past capw
    ([1], [0], [300]),              # count past the batch width
])
def test_queue_append_rejects_contract_violations(rows, fill, count):
    queue = _t(_ring(2, 256, 17))
    keys = _t(np.zeros((len(rows), 256), np.uint32))
    with pytest.raises(ValueError):
        tks.queue_append(queue, keys, rows, fill, count)


def test_flush_inputs_match_reference():
    queue = _ring(4, 256, 18)
    fill = np.asarray([3, 0, 256, 100], np.int32)
    jk, jw = jops.flush_inputs(jnp.asarray(queue), jnp.asarray(fill), 128)
    tk, tw = tops.flush_inputs(_t(queue), fill, 128)
    assert np.array_equal(tc.to_numpy(tk.contiguous()), np.asarray(jk))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    rows = np.asarray([3, 0], np.int32)
    jk, jw = jops.flush_rows_inputs(jnp.asarray(queue), jnp.asarray(fill[rows]),
                                    jnp.asarray(rows), 256)
    tk, tw = tops.flush_rows_inputs(_t(queue), fill[rows], rows, 256)
    assert np.array_equal(tc.to_numpy(tk), np.asarray(jk))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert tops.ring_width(1000) == jops.ring_width(1000)
    assert tuple(tops.queue_init(3, 1000, "cpu").shape) == tuple(
        jops.queue_init(3, 1000).shape)


def test_wrappers_reject_bad_tables():
    _, tcnt = _counters("CMLS16")
    bad = tc.zeros((2, 2, 64), torch.uint32, "cpu")  # unpacked needs uint16
    keys = _t(np.zeros((2, 8), np.uint32))
    with pytest.raises(ValueError):
        tks.fused_query(bad, keys, seeds=SEEDS, width=64, counter=tcnt)
    good = tc.zeros((2, 2, 64), torch.uint16, "cpu")
    with pytest.raises(ValueError):  # width disagrees with the rows
        tks.fused_query(good, keys, seeds=SEEDS, width=128, counter=tcnt)
