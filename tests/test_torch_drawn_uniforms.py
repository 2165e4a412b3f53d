"""The two updates that draw their own uniforms, against the JAX package (CPU).

`kernels.sketch.fused_update_score` (the tracked flush) and
`kernels.sketch.fused_update` (the untracked all-active flush) take the
flush's raw threefry key and the rows of its uniform grid instead of a
uniforms tensor: their CUDA kernels draw element (urows[i], j) of the
(total, N) draw themselves.  On the CPU the wrappers draw it with
`prng.uniform_rows` and run the plain version.  Both packages get the same
seeded numpy inputs; the port's wrapper, fed the pre-deduplicated batch,
must land what the JAX package's `ops.update_score_rows` (its XLA engine)
and `ops.update_many` land from the raw events, with the dense grid and
with a decoupled `uniform_rows` grid.

Tolerances: CMS32 exact everywhere.  Log cells go through float32
expm1 / log1p, whose JAX and torch CPU versions differ by a few ulp
(test_torch_counters), so a log cell may land one state apart where a
stochastic rounding threshold moved: at most 1e-3 of cells, each by one
state; log estimates within 8 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jc
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro_torch.core import counters as tc
from repro_torch.core import prng
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sketch as tks

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
CHUNK = tks.CHUNK


def _specs(name, packed, width=1024):
    return (jsk.SketchSpec(width=width, depth=2, counter=getattr(jc, name),
                           packed=packed),
            tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                           packed=packed))


def _tables(rng, spec, t):
    """(t, 2, sw) storage tables of random states, numpy."""
    hi = min(spec.counter.max_state, 2000)
    cells = rng.integers(0, hi + 1, (t, 2, spec.width)).astype(np.uint32)
    if spec.packed:
        return np.asarray(jc.pack_table(jnp.asarray(cells), spec.counter.bits))
    return cells.astype(spec.counter.dtype)


def _events(rng, r, n):
    """Raw (R, N) events, Zipf-skewed, with weight-0 stale slots and the
    keys 0 and 0xFFFFFFFF."""
    raw = (rng.zipf(1.3, (r, n)) % 3000).astype(np.uint32)
    raw[0, :3] = [0, 0xFFFF_FFFF, 0xFFFF_FFFF]
    w = (rng.random((r, n)) < 0.9).astype(np.float32)
    w[:, -150:] = 0
    return raw, w


def _dedup(raw, w):
    keys, mult = tsk.dedup_weighted(torch.from_numpy(raw.astype(np.int64)),
                                    torch.from_numpy(w))
    return tc.from_i64(keys, torch.uint32), mult


def _cells_close(got, want, spec):
    """Equal storage tables (CMS32), or log cells within one state on at
    most 1e-3 of cells."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if spec.counter.kind == "linear":
        np.testing.assert_array_equal(got, want)
        return
    bits = spec.counter.bits
    if spec.packed:
        got = np.asarray(jc.unpack_table(jnp.asarray(got), bits))
        want = np.asarray(jc.unpack_table(jnp.asarray(want), bits))
    diff = got.astype(np.int64) - want.astype(np.int64)
    assert (diff != 0).mean() <= 1e-3, f"{int((diff != 0).sum())} cells"
    assert np.abs(diff).max() <= 1


GRIDS = {"dense": None, "decoupled": (9, np.asarray([7, 2, 8]))}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name,packed", FORMATS)
def test_fused_update_score_draw_matches_jax_op(name, packed, grid):
    """Three rows (a map that skips and reorders tables) of 2 chunks and a
    ragged tail, candidates with repeats: tables and estimates."""
    js, ts = _specs(name, packed)
    rng = np.random.default_rng(20)
    tables = _tables(rng, js, 5)
    raw, w = _events(rng, 3, 2 * CHUNK + 300)
    rows = np.asarray([4, 0, 2], np.int32)
    cand = np.concatenate([raw[:, :70], raw[:, 500:530]], axis=1)
    key = np.asarray([11, 5], np.uint32)
    jt, jest = jops.update_score_rows(
        jnp.asarray(tables), js, jnp.asarray(raw), key, rows,
        jnp.asarray(cand), weights=jnp.asarray(w),
        uniform_rows=GRIDS[grid], engine="xla")
    keys, mult = _dedup(raw, w)
    tt = tc.from_numpy(tables, "cpu")
    out, est = tks.fused_update_score(
        tt, keys, mult, key, tc.from_numpy(cand, "cpu"), rows,
        grid=GRIDS[grid], seeds=tops._seeds_tuple(ts), width=ts.width,
        counter=ts.counter, cpl=ts.cells_per_lane)
    assert out is tt  # in place
    _cells_close(tc.to_numpy(out), jt, ts)
    np.testing.assert_array_equal(tc.to_numpy(out)[[1, 3]], tables[[1, 3]])
    if ts.counter.kind == "linear":
        np.testing.assert_array_equal(est.numpy(), np.asarray(jest))
    else:
        np.testing.assert_array_max_ulp(est.numpy(), np.asarray(jest),
                                        maxulp=8)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name,packed", FORMATS)
def test_fused_update_draw_matches_jax_op(name, packed, grid):
    """Every table of a 3-table stack, 2 chunks and a ragged tail."""
    js, ts = _specs(name, packed)
    rng = np.random.default_rng(21)
    tables = _tables(rng, js, 3)
    raw, w = _events(rng, 3, 2 * CHUNK + 300)
    key = np.asarray([2, 13], np.uint32)
    want = jops.update_many(jnp.asarray(tables), js, jnp.asarray(raw), key,
                            weights=jnp.asarray(w),
                            uniform_rows=GRIDS[grid])
    keys, mult = _dedup(raw, w)
    tt = tc.from_numpy(tables, "cpu")
    out = tks.fused_update(tt, keys, mult, key, grid=GRIDS[grid],
                           seeds=tops._seeds_tuple(ts), width=ts.width,
                           counter=ts.counter, cpl=ts.cells_per_lane)
    assert out is tt
    _cells_close(tc.to_numpy(out), want, ts)


def test_wrappers_draw_the_grid_rows_of_prng_uniform_rows():
    """On the CPU both wrappers equal their plain versions fed
    `prng.uniform_rows(key, total, N, urows)`, bit for bit, here with a
    grid row whose flat index needs the counter's high word (urows * N
    >= 2^32), and the default grid is (T, rows)."""
    _, ts = _specs("CMLS8", True, width=256)
    rng = np.random.default_rng(22)
    raw, w = _events(rng, 2, CHUNK + 77)
    keys, mult = _dedup(raw, w)
    n = raw.shape[1]
    key = np.asarray([3, 1], np.uint32)
    base = tc.from_numpy(rng.integers(0, 2**32, (4, 2, 256 // 4),
                                      dtype=np.uint64).astype(np.uint32),
                         "cpu")
    kw = dict(seeds=tops._seeds_tuple(ts), width=ts.width,
              counter=ts.counter, cpl=ts.cells_per_lane)
    seed_t = tops._seed_tensor(ts, "cpu")
    urows = np.asarray([2**32 // n + 1, 5])  # 3,971,681 * 1,101 > 2^32
    total = int(urows.max()) + 1
    cand = keys[:, ::5].contiguous()
    for grid in (None, (total, urows)):
        g_total, g_rows = (4, np.asarray([3, 0])) if grid is None else grid
        unif = prng.uniform_rows(key, g_total, n, g_rows)
        got, est = tks.fused_update_score(base.clone(), keys, mult, key,
                                          cand, [3, 0], grid=grid, **kw)
        want, west = tref.update_score_rows_ref(
            base.clone(), keys, mult, unif, torch.tensor([3, 0]), cand,
            seed_t, ts.counter, CHUNK, cpl=ts.cells_per_lane)
        assert torch.equal(got, want) and torch.equal(est, west)
        g_rows = np.arange(2) if grid is None else g_rows
        g_total = 2 if grid is None else g_total
        unif = prng.uniform_rows(key, g_total, n, g_rows)
        got = tks.fused_update(base[:2].clone(), keys, mult, key, grid=grid,
                               **kw)
        want = tref.fused_update_plain(base[:2].clone(), keys, mult, unif,
                                          seed_t, ts.counter, CHUNK,
                                          ts.cells_per_lane)
        assert torch.equal(got, want)


@pytest.mark.parametrize("grid,message", [
    ((4, [0]), "one per batch row"),
    ((4, [0, 4]), r"\[0, 4\)"),
    ((4, [-1, 2]), r"\[0, 4\)"),
    ((2**31, [0, 1]), "outside"),
])
def test_wrappers_check_the_grid(grid, message):
    _, ts = _specs("CMS32", False, width=64)
    keys = tc.from_numpy(np.arange(20, dtype=np.uint32).reshape(2, 10),
                         "cpu")
    mult = torch.ones((2, 10))
    kw = dict(seeds=tops._seeds_tuple(ts), width=64, counter=ts.counter)
    tables = tc.zeros((2, 2, 64), torch.uint32, "cpu")
    with pytest.raises(ValueError, match=message):
        tks.fused_update(tables, keys, mult, [1, 2], grid=grid, **kw)
    with pytest.raises(ValueError, match=message):
        tks.fused_update_score(tables, keys, mult, [1, 2], keys, [1, 0],
                               grid=grid, **kw)
