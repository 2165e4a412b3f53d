"""The CUDA kernels against their plain versions, on the card (small sizes).

Marked `cuda`: these need a GPU and the CUDA toolkit, skip elsewhere, and
run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every kernel must land exactly what its plain PyTorch version lands on
the same device: equal cell states, ring cells and float32 estimates
(the kernels are built with -fmad=false and no fast math, so each float
operation rounds as torch's own CUDA ops do).  `chip_smoke.py` repeats
the comparison at the full-size shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import counters as tc
from repro_torch.core import prng
from repro_torch.core import sketch as tsk
from repro_torch.core.counters import signed_view
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sketch as ksk
from repro_torch.stream import CountService, WindowSpec
from repro_torch.stream import window as tw

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
# the kernels a tracked service of plain tenants launches
TRACKED_PATH = ("fused_query", "fused_update_score", "queue_append",
                "queue_append_dense")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _spec(name, packed, width=4096, depth=2):
    return tsk.SketchSpec(width=width, depth=depth, counter=getattr(tc, name),
                          packed=packed)


# edge cases of the two updates that draw their uniforms in the kernel
# (fused_update_score, fused_update)
DRAW_CASES = ("random", "all_distinct", "one_key", "empty_lead", "short",
              "ragged", "one_row", "deep", "ragged_cand", "hi_word")


def _drawn_case(case, rng, device):
    """(depth, table count, rows, raw keys (R, N), weights, cand (R, M),
    grid) of one drawn update.  "all_distinct": 2 rows of 65,536 distinct
    keys, 64 chunks past the kernel's compaction plan; "one_key": every
    event one key; "empty_lead": the first 5 chunks of each sorted row
    dead (a hot key of weight 0); "short": N < CHUNK; "ragged": N not a
    multiple of CHUNK; "deep": depth 4 (the kernel's instance for depths
    3-8); "ragged_cand": M not a multiple of the score tile; "hi_word": a
    decoupled (70,000, N) grid at rows >= 65,537 with N = 65,536, whose
    flat draw index needs the counter's high word."""
    t, r, n, m, depth, grid = 4, 3, 3000, 500, 2, None
    if case == "all_distinct":
        r, n = 2, 64 * ksk.CHUNK
    elif case == "one_row":
        r = 1
    elif case == "short":
        n = 700
    elif case == "ragged":
        n = 3 * ksk.CHUNK + 333
    elif case == "deep":
        depth, n = 4, 5000
    elif case == "ragged_cand":
        m = 2 * 1024 + 77
    elif case == "empty_lead":
        n = 8 * ksk.CHUNK
    elif case == "hi_word":
        n, grid = 64 * ksk.CHUNK, (70_000, np.asarray([65_537, 69_999, 3]))
    rows = rng.permutation(t)[:r]
    raw = (rng.zipf(1.3, (r, n)) % 20_000).astype(np.uint32)
    w = np.ones((r, n), np.float32)
    w[:, -200:] = 0  # stale ring slots ride along with weight 0
    if case == "all_distinct":
        raw = _distinct_keys(r * n).reshape(r, n)
    elif case == "one_key":
        raw[:] = 77
    elif case == "empty_lead":
        raw[:, :5 * ksk.CHUNK + 100] = 1  # key 1 sorts first
        w[:, :5 * ksk.CHUNK + 100] = 0
    cand = np.concatenate([raw[:, :m - 8], np.asarray(
        [[0, 0xFFFFFFFF, 1, 77, 5, 6, 7, 8]] * r, np.uint32)], axis=1)
    return depth, t, rows, raw, w, cand, grid


def _drawn_plain_uniforms(key, grid, n_tables, rows, n, device):
    total, urows = (n_tables, rows) if grid is None else grid
    return prng.uniform_rows(key, total, n, urows, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DRAW_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
def test_update_score_and_query_kernels_equal_plain(cuda, name, packed,
                                                    case):
    """fused_update_score, uniforms drawn in the kernel, against its plain
    version fed `prng.uniform_rows` of the same key and grid: equal cell
    states and estimates (which proves the draw bit for bit), unlisted
    tables untouched, at the edge cases of DRAW_CASES; then the fused
    query on the updated tables."""
    rng = np.random.default_rng(0)
    depth, t, rows, raw, w, cand, grid = _drawn_case(case, rng, cuda)
    spec = _spec(name, packed, depth=depth)
    skeys, mult = tsk.dedup_weighted(tc.from_numpy(raw, cuda),
                                     torch.from_numpy(w).to(cuda))
    key = np.asarray([1, 2], np.uint32)
    cand = tc.from_numpy(cand, cuda)
    base = _random_cells(rng, spec, (t, depth), cuda)
    tk, tp = base.clone(), base.clone()
    ksk.reset_kernel_launches()
    _, ek = ksk.fused_update_score(tk, ops.as_device_keys(skeys, cuda), mult,
                                   key, cand, rows, grid=grid,
                                   seeds=ops._seeds_tuple(spec),
                                   width=spec.width, counter=spec.counter,
                                   cpl=spec.cells_per_lane)
    unif = _drawn_plain_uniforms(key, grid, t, rows, raw.shape[1], cuda)
    _, ep = ref.update_score_rows_ref(tp, skeys, mult, unif,
                                      torch.from_numpy(rows).to(cuda), cand,
                                      ops._seed_tensor(spec, cuda),
                                      spec.counter, ksk.CHUNK,
                                      cpl=spec.cells_per_lane)
    torch.cuda.synchronize()
    assert ksk.kernel_launches()["fused_update_score"] == 1
    assert torch.equal(signed_view(tk), signed_view(tp))
    assert torch.equal(ek, ep)
    untouched = [i for i in range(t) if i not in rows]
    assert torch.equal(signed_view(tk)[untouched],
                       signed_view(base)[untouched])
    probes = tc.from_numpy(raw[0, :700].copy(), cuda)  # broadcast to all
    qk = ops.query_many(tk, spec, probes, engine="auto")
    qp = ops.query_many(tk, spec, probes, engine="plain")
    assert torch.equal(qk, qp)


def _random_cells(rng, spec, lead, device):
    """Storage-layout tables (*lead, sw) of random cell states."""
    states = rng.integers(0, min(3000, spec.counter.max_state + 1),
                          lead + (spec.width,))
    return tsk.storage_table(torch.from_numpy(states), spec).to(device)


# edge cases of the two row-mapped kernels (fused_update_rows,
# window_query_stacked_rows), beside the random inputs of the first port
UPDATE_CASES = ("random", "split", "one_row", "all_distinct", "one_key",
                "extreme_keys", "mult_zero", "high_states", "many_live",
                "deep")
WINDOW_CASES = ("random", "split", "one_row", "one_key", "all_distinct",
                "extreme_keys", "passes")


def _distinct_keys(n: int) -> np.ndarray:
    """n distinct uint32 keys spread over the whole range (an odd
    multiplier is a bijection mod 2^32)."""
    return np.arange(n, dtype=np.uint32) * np.uint32(2654435761)


def _update_rows_case(case, spec, rng, device):
    """(tables, rows, raw keys (R, N), weights, uniforms) of one
    row-mapped update: rows a unique map into a larger stack of random
    cell states; "split" maps MAX_MAPPED_ROWS + 37 rows (two launches),
    "high_states" starts every cell within 9 states of the maximum
    (CMLS8: states 246-255) with u = 0 and n in {450, 1489, 1923, 10000},
    where the log counter's nfold steps one state past the reference
    property test's bound; "many_live" gives each row over 9,000 live
    keys, more than the kernel compacts before its chunk loop (each
    chunk's threads then take their own slots); "deep" is a depth-4
    sketch (the kernel's instance for depths 3-8) with rows of 34
    chunks."""
    t, r, n = 8, 3, 2500
    if case == "split":
        t, r, n = ksk.MAX_MAPPED_ROWS + 40, ksk.MAX_MAPPED_ROWS + 37, 1100
    elif case == "one_row":
        r = 1
    elif case == "many_live":
        r, n = 2, 9300
    elif case == "deep":
        r, n = 2, 33 * ksk.CHUNK + 100
    if case == "high_states":
        top = spec.counter.max_state
        states = rng.integers(top - 9, top + 1, (t, spec.depth, spec.width))
        tables = tsk.storage_table(torch.from_numpy(states), spec).to(device)
    else:
        tables = _random_cells(rng, spec, (t, spec.depth), device)
    rows = rng.permutation(t)[:r]
    raw = rng.integers(0, 3000, (r, n)).astype(np.uint32)
    if case in ("all_distinct", "many_live"):
        raw = _distinct_keys(r * n).reshape(r, n)
    elif case == "one_key":
        raw[:] = 77
    elif case == "extreme_keys":
        raw = rng.choice(np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE], np.uint32),
                         (r, n))
    w = np.ones((r, n), np.float32)
    w[:, -300:] = 0  # stale ring slots ride along with weight 0
    if case == "mult_zero":
        w[:] = 0
    elif case == "high_states":
        w = rng.choice(np.array([450, 1489, 1923, 10000, 1], np.float32),
                       (r, n))
    unif = ops._parity_uniforms([4, 5], n, t, rows, device)
    if case == "high_states":
        unif = torch.zeros_like(unif)
    return (tables, rows, tc.from_numpy(raw, device),
            torch.from_numpy(w).to(device), unif)


# fused_update (the dense update, uniforms drawn in the kernel) at the
# edge cases of the drawn updates (its rows are every table, so
# "ragged_cand" has nothing to add)
DENSE_CASES = tuple("dense_" + c for c in DRAW_CASES if c != "ragged_cand")


@pytest.mark.cuda
@pytest.mark.parametrize("case", UPDATE_CASES + DENSE_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
def test_untracked_update_kernels_equal_plain(cuda, name, packed, case):
    """fused_update (every table; its uniforms drawn in the kernel, the
    plain version fed `prng.uniform_rows` of the same key and grid) and
    fused_update_rows (a row map into a larger stack, as the window
    flush's flat leaf) against their plain versions: equal cell states,
    unlisted tables untouched; fused_update_rows also at the edge cases
    of UPDATE_CASES, fused_update at those of DENSE_CASES."""
    spec = _spec(name, packed,
                 depth=4 if case in ("deep", "dense_deep") else 2)
    rng = np.random.default_rng(3)
    seed_t = ops._seed_tensor(spec, cuda)
    kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
              counter=spec.counter, cpl=spec.cells_per_lane)
    if case.startswith("dense_"):
        _, _, _, raw, w, _, grid = _drawn_case(case[len("dense_"):], rng,
                                               cuda)
        r, n = raw.shape
        skeys, mult = tsk.dedup_weighted(tc.from_numpy(raw, cuda),
                                         torch.from_numpy(w).to(cuda))
        key = np.asarray([4, 5], np.uint32)
        base = _random_cells(rng, spec, (r, spec.depth), cuda)
        ta, tp = base.clone(), base.clone()
        ksk.reset_kernel_launches()
        ksk.fused_update(ta, ops.as_device_keys(skeys, cuda), mult, key,
                         grid=grid, **kw)
        unif = _drawn_plain_uniforms(key, grid, r, np.arange(r), n, cuda)
        ref.fused_update_plain(tp, skeys, mult, unif, seed_t, spec.counter,
                               ksk.CHUNK, cpl=spec.cells_per_lane)
        torch.cuda.synchronize()
        assert ksk.kernel_launches()["fused_update"] == 1
        assert torch.equal(signed_view(ta), signed_view(tp))
        return
    if case != "random":
        base, rows, raw, w, unif = _update_rows_case(case, spec, rng, cuda)
        skeys, mult = tsk.dedup_weighted(raw, w)
        ta, tp = base.clone(), base.clone()
        ksk.reset_kernel_launches()
        ksk.fused_update_rows(ta, ops.as_device_keys(skeys, cuda), mult,
                              unif, rows, **kw)
        ref.fused_update_rows_plain(tp, skeys, mult, unif,
                                    torch.from_numpy(rows), seed_t,
                                    spec.counter, ksk.CHUNK,
                                    cpl=spec.cells_per_lane)
        torch.cuda.synchronize()
        assert ksk.kernel_launches()["fused_update_rows"] == 1
        assert torch.equal(signed_view(ta), signed_view(tp))
        if case == "mult_zero":
            assert torch.equal(signed_view(ta), signed_view(base))
        return
    raw = tc.from_numpy(rng.integers(0, 3000, (3, 2500)).astype(np.uint32),
                        cuda)
    w = torch.ones(raw.shape, dtype=torch.float32, device=cuda)
    w[:, -300:] = 0  # stale ring slots ride along with weight 0
    skeys, mult = tsk.dedup_weighted(raw, w)
    keys = ops.as_device_keys(skeys, cuda)
    unif = ops._parity_uniforms([4, 5], raw.shape[1], 3, [0, 1, 2], cuda)
    base = _random_cells(rng, spec, (8, 2), cuda)
    ta, tp = base[:3].clone(), base[:3].clone()
    ksk.fused_update(ta, keys, mult, [4, 5], **kw)
    ref.fused_update_plain(tp, skeys, mult, unif, seed_t, spec.counter,
                           ksk.CHUNK, cpl=spec.cells_per_lane)
    assert torch.equal(signed_view(ta), signed_view(tp))
    rows = [6, 1, 3]
    ta, tp = base.clone(), base.clone()
    ksk.fused_update_rows(ta, keys, mult, unif, rows, **kw)
    ref.fused_update_rows_plain(tp, skeys, mult, unif, torch.tensor(rows),
                                seed_t, spec.counter, ksk.CHUNK,
                                cpl=spec.cells_per_lane)
    assert torch.equal(signed_view(ta), signed_view(tp))
    untouched = [r for r in range(8) if r not in rows]
    assert torch.equal(signed_view(ta)[untouched],
                       signed_view(base)[untouched])


def _window_rows_case(case, rng, t):
    """(rows, keys (R, N) numpy) of one row-mapped window read of a
    t-ring leaf: "split" reads MAX_MAPPED_ROWS + 37 rings (repeats
    allowed: a read), "all_distinct" a ring's 16,448 candidates all
    distinct, "passes" 300,000 distinct candidates a ring (every 97th the
    key 0xFFFFFFFF) on the 8 x 2 instance, over 1,000 blocks a ring."""
    rows, n = [4, 0, 2], 777
    if case == "split":
        rows, n = rng.integers(0, t, ksk.MAX_MAPPED_ROWS + 37), 64
    elif case == "one_row":
        rows = [3]
    elif case == "all_distinct":
        n = 16_448
    elif case == "passes":
        rows, n = [1, 3], 300_000
    r = len(rows)
    keys = rng.integers(0, 3000, (r, n)).astype(np.uint32)
    if case in ("all_distinct", "passes"):
        keys = _distinct_keys(r * n).reshape(r, n)
        if case == "passes":
            keys[:, ::97] = 0xFFFFFFFF
    elif case == "one_key":
        keys[:] = 12345
    elif case == "extreme_keys":
        keys = rng.choice(np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE],
                                   np.uint32), (r, n))
    return np.asarray(rows), keys


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_window_query_kernels_equal_plain(cuda, name, packed, mode, case):
    """The three window queries against their plain versions, bit for
    bit, with random weights (gamma-like) and random cell states; the
    row-mapped one also at the edge cases of WINDOW_CASES, on an 8-bucket
    leaf (the kernel's instance for the windowed path's 8 x 2 geometry;
    the random case's 4 buckets take its general instance)."""
    spec = _spec(name, packed)
    rng = np.random.default_rng(4)
    if case != "random":
        t, b = 5, 8
        leaf = _random_cells(rng, spec, (t, b, 2), cuda)
        rows, keys = _window_rows_case(case, rng, t)
        wts = torch.from_numpy(rng.random((len(rows), b)).astype(
            np.float32)).to(cuda)
        wts[0, 5] = 0.0  # an expired bucket
        keys = tc.from_numpy(keys, cuda)
        ksk.reset_kernel_launches()
        got = ksk.window_query_stacked_rows(
            leaf, keys, wts, rows, seeds=ops._seeds_tuple(spec),
            width=spec.width, counter=spec.counter, mode=mode,
            cpl=spec.cells_per_lane)
        want = ref.window_query_stacked_rows_plain(
            leaf, keys, wts, torch.from_numpy(rows),
            ops._seed_tensor(spec, cuda), spec.width, spec.counter, mode,
            spec.cells_per_lane)
        torch.cuda.synchronize()
        assert ksk.kernel_launches()["window_query_stacked_rows"] == 1
        assert torch.equal(got, want)
        return
    t, b = 5, 4
    leaf = _random_cells(rng, spec, (t, b, 2), cuda)
    keys = tc.from_numpy(rng.integers(0, 2**32, (3, 777), dtype=np.uint64)
                         .astype(np.uint32), cuda)
    wts = torch.from_numpy(rng.random((3, b)).astype(np.float32)).to(cuda)
    wts[1, 2] = 0.0  # an expired bucket
    seeds, seed_t = ops._seeds_tuple(spec), ops._seed_tensor(spec, cuda)
    kw = dict(seeds=seeds, width=spec.width, counter=spec.counter, mode=mode,
              cpl=spec.cells_per_lane)
    rows = [4, 0, 2]
    got = ksk.window_query_stacked_rows(leaf, keys, wts, rows, **kw)
    want = ref.window_query_stacked_rows_plain(
        leaf, keys, wts, torch.tensor(rows), seed_t, spec.width,
        spec.counter, mode, spec.cells_per_lane)
    assert torch.equal(got, want)
    rings = signed_view(leaf)[rows].view(leaf.dtype)
    got = ksk.window_query_stacked(rings, keys, wts, **kw)
    assert torch.equal(got, want)
    one = ksk.window_query(rings[1], keys[1].contiguous(),
                           wts[1].contiguous(), **kw)
    assert torch.equal(one, ref.window_query_plain(
        rings[1], keys[1], wts[1], seed_t, spec.width, spec.counter, mode,
        spec.cells_per_lane))
    assert torch.equal(one, want[1])


# edge cases of kernels 7 and 8 (window_query, window_query_stacked): one
# lane a (key, bucket), buckets of weight 0 not read, keys with a ring
# stride (0: one row shared by every ring)
LANE_CASES = ("random", "bucket0_zero", "all_zero", "n_buckets",
              "stride0", "one_key_n", "ragged", "passes", "extreme_keys",
              "repeated")


def _lane_case(case, rng, r):
    """(keys (r, N) or (N,) numpy, weight sets [(label, (r, B) numpy)]) of
    one window read of r rings of 8 buckets."""
    n = 777
    if case == "one_key_n":  # N = 1
        n = 1
    elif case == "ragged":  # N not a multiple of any block's keys
        n = 4096 + 33
    elif case == "passes":  # 300,000 keys a ring: 9,375 blocks a ring
        n = 300_000
    keys = rng.integers(0, 2**32, (r, n), dtype=np.uint64).astype(np.uint32)
    if case == "passes":
        keys = _distinct_keys(r * n).reshape(r, n)
        keys[:, ::97] = 0xFFFFFFFF
    elif case == "extreme_keys":
        keys = rng.choice(np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE],
                                   np.uint32), (r, n))
    elif case == "repeated":
        keys = rng.integers(0, 5, (r, n)).astype(np.uint32)
    elif case == "stride0":
        keys = keys[0]
    full = rng.random((r, 8)).astype(np.float32)
    if case == "bucket0_zero":
        full[:, 0] = 0.0
        full[1, 3] = 0.0
    elif case == "all_zero":
        full[:] = 0.0
    sets = [("weights", full)]
    if case == "n_buckets":  # window_weights_stacked's masks, k = 1..8
        cursors = np.arange(r) % 8
        sets = [(f"n_buckets={k}",
                 tw.window_weights_stacked(cursors, 8, k).numpy())
                for k in range(1, 9)]
    return keys, sets


@pytest.mark.cuda
@pytest.mark.parametrize("case", LANE_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_window_lane_kernels_equal_plain(cuda, name, packed, mode, case):
    """Kernels 7 and 8 against their plain versions, bit for bit, on
    rings of 8 x 2 (the template instance) at the edge cases of
    LANE_CASES: a zero weight at bucket 0, every weight zero, the
    n_buckets masks 1..8, (N,) keys shared by every ring (ring stride 0),
    N = 1, N not a multiple of the tile,
    300,000 keys a ring, keys 0 and 0xFFFFFFFF, repeated keys; one
    launch a call."""
    spec = _spec(name, packed)
    rng = np.random.default_rng(9)
    r = 5
    rings = _random_cells(rng, spec, (r, 8, 2), cuda)
    keys_np, sets = _lane_case(case, rng, r)
    keys = tc.from_numpy(keys_np, cuda)
    seed_t = ops._seed_tensor(spec, cuda)
    kw = dict(width=spec.width, counter=spec.counter, mode=mode,
              cpl=spec.cells_per_lane)
    plain_keys = keys if keys.dim() == 2 else keys.expand(r, -1)
    for label, wts_np in sets:
        wts = torch.from_numpy(wts_np).to(cuda)
        ksk.reset_kernel_launches()
        got = ksk.window_query_stacked(rings, keys, wts,
                                       seeds=ops._seeds_tuple(spec), **kw)
        one = ksk.window_query(rings[2], plain_keys[2].contiguous(),
                               wts[2].contiguous(),
                               seeds=ops._seeds_tuple(spec), **kw)
        want = ref.window_query_stacked_plain(rings, plain_keys, wts, seed_t,
                                              **kw)
        torch.cuda.synchronize()
        launches = ksk.kernel_launches()
        assert launches["window_query_stacked"] == 1, label
        assert launches["window_query"] == 1, label
        assert torch.equal(got, want), label
        assert torch.equal(one, want[2]), label
        if case == "all_zero":
            assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("buckets,depth", [(4, 3), (1, 2), (3, 8),
                                           (33, 1)])
@pytest.mark.parametrize("name,packed", FORMATS)
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_window_lane_kernels_general_instance(cuda, name, packed, mode,
                                              buckets, depth):
    """The general instance of kernels 7 and 8 (any B, any depth up to
    8; B = 33 reduces in two rounds of 32 buckets) against the plain
    versions, per-ring and shared keys, with zero weights."""
    spec = _spec(name, packed, depth=depth)
    rng = np.random.default_rng(10)
    r = 3
    rings = _random_cells(rng, spec, (r, buckets, depth), cuda)
    keys = tc.from_numpy(rng.integers(0, 2**32, (r, 1000), dtype=np.uint64)
                         .astype(np.uint32), cuda)
    wts_np = rng.random((r, buckets)).astype(np.float32)
    wts_np[0, 0] = 0.0
    wts_np[2, buckets // 2:] = 0.0
    wts = torch.from_numpy(wts_np).to(cuda)
    seeds, seed_t = ops._seeds_tuple(spec), ops._seed_tensor(spec, cuda)
    kw = dict(width=spec.width, counter=spec.counter, mode=mode,
              cpl=spec.cells_per_lane)
    for probes in (keys, keys[1]):
        plain_keys = probes if probes.dim() == 2 else probes.expand(r, -1)
        got = ksk.window_query_stacked(rings, probes, wts, seeds=seeds, **kw)
        want = ref.window_query_stacked_plain(rings, plain_keys, wts, seed_t,
                                              **kw)
        assert torch.equal(got, want)
    one = ksk.window_query(rings[0], keys[0], wts[0], seeds=seeds, **kw)
    assert torch.equal(one, ref.window_query_plain(
        rings[0], keys[0], wts[0], seed_t, **kw))


def _append_case(case, kind, rng, device):
    """(ring, keys, rows, fill, count) of one append edge case: rows None
    for the dense kernel (batch row i -> ring row i)."""
    t, capw, n = 6, 2048, 1024
    if case == "split":  # more rows than one launch carries
        t, capw, n = ksk.MAX_APPEND_ROWS + 37, 256, 128
    if case == "odd_width":  # n % 4 != 0 and a key base off 16 bytes
        n = 1021
    ring = tc.from_numpy(rng.integers(0, 2**32, (t, capw), dtype=np.uint64)
                         .astype(np.uint32), device)
    r = t if kind == "dense" else max(1, t - 2)
    rows = None if kind == "dense" else rng.permutation(t)[:r]
    flat = tc.from_numpy(rng.integers(0, 2**32, r * n + 1, dtype=np.uint64)
                         .astype(np.uint32), device)
    keys = (flat[1:] if case == "odd_width" else flat[:-1]).view(r, n)
    count = rng.integers(1, n + 1, r)
    fill = rng.integers(0, capw - n + 1, r)
    if case == "aligned_fill":
        fill -= fill % 4
    elif case == "odd_fill":
        fill |= 1
    elif case == "zero_count":
        count[::2] = 0
    elif case == "full_row":
        fill = capw - count
    return ring, keys, rows, fill, count


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rows", "dense"])
@pytest.mark.parametrize("case", ["aligned_fill", "odd_fill", "odd_width",
                                  "zero_count", "full_row", "split"])
def test_queue_appends_equal_plain(cuda, case, kind):
    """Both append kernels against their plain versions on the card: the
    16- and 4-byte access paths, ragged and zero counts, rows that end at
    capw, and a call split over launches of MAX_APPEND_ROWS rows."""
    rng = np.random.default_rng(1)
    ring, keys, rows, fill, count = _append_case(case, kind, rng, cuda)
    a, b = ring.clone(), ring.clone()

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(cuda)
    ksk.reset_kernel_launches()
    if kind == "dense":
        ksk.queue_append_dense(a, keys, fill, count)
        ref.queue_append_dense_plain(b, keys, dev(fill), dev(count))
    else:
        ksk.queue_append(a, keys, rows, fill, count)
        ref.queue_append_plain(b, keys, dev(rows), dev(fill), dev(count))
    torch.cuda.synchronize()
    assert ksk.kernel_launches()["queue_append" if kind == "rows"
                                 else "queue_append_dense"] == 1
    assert torch.equal(signed_view(a), signed_view(b))
    if case == "zero_count":  # a call with nothing to land launches nothing
        c = a.clone()
        zeros = np.zeros_like(count)
        if kind == "dense":
            ksk.queue_append_dense(c, keys, fill, zeros)
        else:
            ksk.queue_append(c, keys, rows, fill, zeros)
        torch.cuda.synchronize()
        assert torch.equal(signed_view(c), signed_view(a))


@pytest.mark.cuda
def test_enqueue_many_does_not_synchronize(cuda):
    """`enqueue_many` on a tracked and a windowed service issues no
    synchronizing CUDA call: eight microbatches that fill the rings exactly
    and whose event times stay inside one interval (so nothing flushes and
    nothing rotates) run under torch.cuda.set_sync_debug_mode("error").
    The rings then equal those of the plain engine on the same stream."""
    spec = _spec("CMLS16", False)
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    names, wnames = [f"t{i}" for i in range(4)], ["x", "y", "z"]
    rng = np.random.default_rng(6)
    micro = [{n: rng.integers(0, 2**32, 256, dtype=np.uint64)
              .astype(np.uint32) for n in names[:4 - i % 2]}
             for i in range(8)]
    wmicro = [{n: rng.zipf(1.3, 256).astype(np.uint32) for n in wnames}
              for _ in range(8)]
    out = []
    for engine in ("auto", "plain"):
        flat = CountService(spec, tenants=names, queue_capacity=2048,
                            track_top=8, device=cuda, engine=engine)
        win = CountService(queue_capacity=2048, track_top=8, device=cuda,
                           engine=engine)
        for n in wnames:
            win.add_tenant(n, window=wspec)
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i, (ev, wev) in enumerate(zip(micro, wmicro)):
                flat.enqueue_many(ev)
                win.enqueue_many(wev, ts=600.0 + i)
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        assert flat.stats["flushes"] == win.stats["flushes"] == 0
        assert win.planes[0].ring.fill.tolist() == [2048] * 3
        out.append((flat.planes[0].ring, win.planes[0].ring))
    for ra, rp in zip(*out):
        assert np.array_equal(ra.fill, rp.fill)
        assert torch.equal(signed_view(ra.queue), signed_view(rp.queue))


@pytest.mark.cuda
def test_flush_does_not_synchronize(cuda):
    """The flush path issues no synchronizing CUDA call: a tracked flush,
    window flushes of one and of two fill classes, and a windowed
    `enqueue_many(..., ts=)` that flushes and rotates run under
    torch.cuda.set_sync_debug_mode("error").  Tables, leaves, cursors,
    watermarks, rings, fills and trackers then equal the plain engine's
    on the same stream."""
    spec = _spec("CMLS16", False)
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    names, wnames = [f"t{i}" for i in range(4)], ["x", "y", "z"]
    rng = np.random.default_rng(7)

    def zipf(n):
        return rng.zipf(1.3, n).astype(np.uint32) % 5000
    flat_ev = {n: zipf(900) for n in names}
    win_evs = [({n: zipf(700) for n in wnames}, 600.0),        # one class
               ({"x": zipf(300), "y": zipf(1500)}, 610.0),      # two
               ({"z": zipf(500)}, 620.0),                       # pending,
               ({"x": zipf(400), "z": zipf(200)}, 745.0)]       # then rotate
    first = {n: zipf(10) for n in wnames}  # sets the watermarks
    out = []
    for engine in ("auto", "plain"):
        flat = CountService(spec, tenants=names, queue_capacity=4096,
                            track_top=8, device=cuda, engine=engine)
        win = CountService(queue_capacity=4096, track_top=8, device=cuda,
                           engine=engine)
        for n in wnames:
            win.add_tenant(n, window=wspec)
        win.enqueue_many(first, ts=590.0)
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            flat.enqueue_many(flat_ev)
            flat.flush()
            for i, (ev, ts) in enumerate(win_evs):
                win.enqueue_many(ev, ts=ts)
                if i < 2:
                    win.flush()
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        assert win.planes[0].cursors.tolist() == [3, 1, 3]
        out.append((flat, win))
    for a, b in zip(*out):
        _, ta = convert.service_to_numpy(a)
        _, tb = convert.service_to_numpy(b)
        for kind in ("planes", "windows"):
            for la, lb in zip(ta[kind], tb[kind]):
                for key, va in la.items():
                    if isinstance(va, dict):
                        for sub, x in va.items():
                            assert np.array_equal(x, lb[key][sub]), (key, sub)
                    else:
                        assert np.array_equal(va, lb[key]), key


@pytest.mark.cuda
def test_windowed_reads_do_not_synchronize(cuda):
    """A windowed service's reads issue no synchronizing CUDA call:
    `query` (full window, n_buckets, gamma, max) and `query_all` (shared
    and per-tenant probes) run under torch.cuda.set_sync_debug_mode
    ("error") after rotations.  Each answer equals the plain engine's on
    the same stream."""
    spec = _spec("CMLS16", False)
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    names = ["x", "y", "z"]
    rng = np.random.default_rng(8)
    stream = [({n: (rng.zipf(1.3, 500) % 3000).astype(np.uint32)
                for n in names}, ts) for ts in (10.0, 75.0, 200.0)]
    probes = rng.integers(0, 3000, (4, 300)).astype(np.uint32)
    reads = [lambda s: s.query("y", probes[2]),
             lambda s: s.query("y", probes[2], n_buckets=2),
             lambda s: s.query("y", probes[2], gamma=0.9),
             lambda s: s.query("y", probes[2], mode="max"),
             lambda s: s.query_all(probes[0]),
             lambda s: s.query_all(probes)]
    out = []
    for engine in ("auto", "plain"):
        svc = CountService(queue_capacity=4096, track_top=8, device=cuda,
                           engine=engine)
        svc.add_tenant("m", spec=_spec("CMS32", False))
        for n in names:
            svc.add_tenant(n, window=wspec)
        for events, ts in stream:
            svc.enqueue_many(events, ts=ts)
            svc.flush()
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = [read(svc) for read in reads]
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        out.append(got)
    for a, b in zip(*out):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for n in a:
                assert torch.equal(a[n], b[n]), n
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_tracked_and_untracked_flushes_draw_no_uniform_tensor(cuda,
                                                              monkeypatch):
    """On the card the tracked flush (fused_update_score) and the
    untracked all-active flush (fused_update) draw their uniforms inside
    the kernels: with `prng.uniform_rows` made to raise, both flush, and
    their tables equal those of the plain engine (run after, with the
    draw restored) on the same stream."""
    spec = _spec("CMLS16", False)
    names = [f"t{i}" for i in range(4)]
    rng = np.random.default_rng(8)
    epochs = [{n: rng.zipf(1.3, 900).astype(np.uint32) % 5000
               for n in names} for _ in range(2)]

    def drive(engine):
        tracked = CountService(spec, tenants=names, queue_capacity=2048,
                               track_top=8, device=cuda, engine=engine)
        flat = CountService(spec, tenants=names, queue_capacity=2048,
                            device=cuda, engine=engine)
        for events in epochs:
            for svc in (tracked, flat):
                svc.enqueue_many(events)
                svc.flush()
        torch.cuda.synchronize()
        return tracked, flat

    def refuse(*args, **kw):
        raise AssertionError("a uniform tensor was drawn")

    with monkeypatch.context() as mp:
        mp.setattr(prng, "uniform_rows", refuse)
        ksk.reset_kernel_launches()
        auto = drive("auto")
        launches = ksk.kernel_launches()
    assert launches["fused_update_score"] == 2
    assert launches["fused_update"] == 2
    plain = drive("plain")
    for a, p in zip(auto, plain):
        assert a.stats["flushes"] == p.stats["flushes"] == 2
        assert torch.equal(signed_view(a.planes[0].tables),
                           signed_view(p.planes[0].tables))
    assert np.array_equal(auto[0].planes[0].tracker.keys.cpu().numpy(),
                          plain[0].planes[0].tracker.keys.cpu().numpy())


@pytest.mark.cuda
def test_service_auto_equals_plain_and_launches_every_kernel(cuda):
    spec = _spec("CMLS16", False)
    names = [f"t{i}" for i in range(4)]
    services = []
    ksk.reset_kernel_launches()
    for engine in ("auto", "plain"):
        svc = CountService(spec, tenants=names, queue_capacity=1024,
                           track_top=8, device=cuda, engine=engine)
        rng = np.random.default_rng(2)
        for _ in range(3):
            svc.enqueue_many({n: rng.zipf(1.3, 400).astype(np.uint32) % 999
                              for n in names})
            svc.enqueue("t1", rng.integers(0, 99, 300))
        est = svc.query_all(np.arange(64))
        services.append((svc, est))
        if engine == "auto":
            launches = ksk.kernel_launches()
            assert all(launches[k] > 0 for k in TRACKED_PATH), launches
    (a, ea), (b, eb) = services
    assert torch.equal(signed_view(a.planes[0].tables),
                       signed_view(b.planes[0].tables))
    for n in names:
        assert torch.equal(ea[n], eb[n])


@pytest.mark.cuda
def test_window_and_untracked_services_auto_equal_plain(cuda):
    """A windowed tracked service and an untracked plain one, kernels
    against the plain engine on the card: equal leaves, cursors and
    answers, and the five kernels of these paths launched."""
    wspec = WindowSpec(sketch=_spec("CMLS16", True), buckets=4,
                       interval=60.0)
    out = []
    ksk.reset_kernel_launches()
    for engine in ("auto", "plain"):
        win = CountService(queue_capacity=2048, track_top=8, device=cuda,
                           engine=engine)
        flat = CountService(_spec("CMLS8", False), tenants=["a", "b", "c"],
                            queue_capacity=2048, device=cuda, engine=engine)
        for n in ("x", "y", "z"):
            win.add_tenant(n, window=wspec)
        rng = np.random.default_rng(5)
        ts = 0.0
        for step in range(10):
            ts += float(rng.exponential(50.0))
            win.enqueue_many({n: rng.zipf(1.3, 300).astype(np.uint32) % 999
                              for n in ("x", "y", "z")[:1 + step % 3]},
                             ts=ts)
            flat.enqueue_many({n: rng.zipf(1.3, 700 * (1 + i * (step % 2)))
                               .astype(np.uint32) % 999
                               for i, n in enumerate(("a", "b", "c"))})
            flat.flush()
        res = (win.query_all(np.arange(64)), win.query("y", np.arange(64),
                                                       gamma=0.9),
               win.topk("x", mode="max"), flat.query_all(np.arange(64)))
        out.append((win, flat, res))
    launches = ksk.kernel_launches()
    assert all(launches[k] > 0 for k in (
        "fused_update", "fused_update_rows", "window_query",
        "window_query_stacked", "window_query_stacked_rows")), launches
    (wa, fa, ra), (wp, fp, rp) = out
    assert torch.equal(signed_view(wa.planes[0].tables),
                       signed_view(wp.planes[0].tables))
    assert np.array_equal(wa.planes[0].cursors, wp.planes[0].cursors)
    assert torch.equal(signed_view(fa.planes[0].tables),
                       signed_view(fp.planes[0].tables))
    for n in ra[0]:
        assert torch.equal(ra[0][n], rp[0][n])
    assert torch.equal(ra[1], rp[1])
    assert all(np.array_equal(x, y) for x, y in zip(ra[2], rp[2]))
    for n in ra[3]:
        assert torch.equal(ra[3][n], rp[3][n])
